"""The bf16 edge head's packed operands (``pack_head_weights_bf16``): a
plain product over exactly that packing, gathered first as the card's
gather-first kernel forms it (per window the patch ``[x[idx[:, wp]] | .. |
x[idx[:, wp+window-1]] | x]`` of channels zero-padded to ``cp``, one product
with ``W_conv^T``'s rows; the merge's ``[x[idx[:, 0]] | .. | x[idx[:, k-1]]
| x]`` with ``W_merge^T``'s), held against ``head_reference_given_idx`` in
bf16: ``inte`` within 1 ulp (both sum exact products in fp32 in other
orders and round once), ``partial`` rel <= 1e-5. A packing fault (a block
out of place, a wrong pad, a transposed block) moves whole columns and
shows here before the card runs the kernel.
"""

import numpy as np
import pytest
import torch

from torch_port_util import bf16_ulps, one_torch_thread, rel  # noqa: F401

from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.edge_head import (head_operands,
                                                  head_reference_given_idx,
                                                  pack_head_weights_bf16)
from pdgn_tpu_torch.ops.knn import knn_exclude_first
from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

BF = torch.bfloat16


def _operands(seed, B, N, C, cx, k, four_fin, two_f):
    """bf16 features and weights (the weights rounded as the head's
    autograd Function rounds them), fp32 pb_*, and the graph."""
    rng = np.random.RandomState(seed)
    cf = C + cx
    window = k // 2 + 1

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    x = r(B, N, C, scale=0.5).to(BF)
    xs = r(B, cx, scale=0.5).to(BF) if cx else None
    ops = head_operands(x, r(1, window, 2 * cf, four_fin, scale=0.1),
                        r(four_fin, scale=0.1),
                        r(2 * k * 2 * cf, two_f, scale=0.05), k, xs)
    x_knn, wn, ca, pb, am, wen, pbm, window = ops
    wn, ca, am, wen = (w.to(BF) for w in (wn, ca, am, wen))
    idx = knn_exclude_first(self_pairwise_sqdist(x_knn.float()), k)
    return x, wn, ca, pb, am, wen, pbm, idx, window


def packed_product(x, idx, w_conv, w_merge, pb_point, pb_merge, k, window):
    """``inte`` and ``partial`` from the packed operands, gathered first:
    fp32 products of the bf16 values, ``inte`` rounded to bf16."""
    B, N, C = x.shape
    cp = _lib.up64(C)
    xp = torch.nn.functional.pad(x.float(), (0, cp - C))
    nbr = grouping(xp, idx)                              # (B, N, k, cp)
    wc, wm = w_conv.float(), w_merge.float()
    parts = []
    for wp in range(k // 2):
        patch = torch.cat([nbr[:, :, wp + t] for t in range(window)] + [xp],
                          dim=-1)
        parts.append((patch @ wc.T + pb_point[:, None, :]).to(BF))
    flat = torch.cat([nbr[:, :, j] for j in range(k)] + [xp], dim=-1)
    return torch.cat(parts, dim=-1), flat @ wm.T + pb_merge[:, None, :]


@pytest.mark.parametrize("B,N,C,cx,k,four_fin,two_f", [
    (2, 40, 40, 0, 6, 160, 80),       # C padded to 64
    (2, 33, 64, 64, 10, 512, 256),    # C a whole slab, the xs half folded
    (1, 50, 24, 8, 2, 300, 130),      # k=2; widths off the kernel's tiles
    (1, 70, 96, 0, 14, 129, 65)])     # C padded to 128; odd widths
def test_packed_product_matches_reference(B, N, C, cx, k, four_fin, two_f):
    x, wn, ca, pb, am, wen, pbm, idx, window = _operands(
        B + N + C + k, B, N, C, cx, k, four_fin, two_f)
    cp = _lib.up64(C)
    w_conv, w_merge = pack_head_weights_bf16(wn, ca, am, wen, k, window)
    assert w_conv.dtype == w_merge.dtype == BF
    assert tuple(w_conv.shape) == (four_fin, (window + 1) * cp)
    assert tuple(w_merge.shape) == (two_f, (k + 1) * cp)
    assert w_conv.is_contiguous() and w_merge.is_contiguous()
    # the pad rows of every slot's block are zeros
    assert not w_conv.reshape(four_fin, window + 1, cp)[..., C:].any()
    assert not w_merge.reshape(two_f, k + 1, cp)[..., C:].any()
    inte, partial = packed_product(x, idx, w_conv, w_merge, pb, pbm, k,
                                   window)
    want = head_reference_given_idx(x, wn, ca, pb, am, wen, pbm, None, None,
                                    idx, k, window)
    assert inte.dtype == want[0].dtype == BF
    assert inte.shape == want[0].shape
    assert bf16_ulps(inte, want[0]) <= 1.0
    assert rel(partial, want[1]) <= 1e-5
