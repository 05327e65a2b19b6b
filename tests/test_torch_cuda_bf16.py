"""The bf16 instances of the port's forward kernels (edge head, slot stats,
both tails: ``--compute_dtype bfloat16``) against their bf16 plain
versions, on the card, at small and ragged shapes that the full-width
checks of ``chip_smoke.py`` phase 2b never hit: row counts that fill no
tile, channel counts off multiples of 8 (a 16-byte granule of bf16, so
``x``, ``wi`` and ``g`` are padded), k from 6 to 126, 2Fin odd (the gate
stages those channels by plain loads). bf16 outputs within 2 ulps of the
larger magnitude, counted at no less than 1/256 of the largest
(``torch_port_util.bf16_ulps``, phase 2b's measure and limit; the tails'
y held to the float64 merge of their own g, as phase 2b holds it); fp32
outputs rel <= 1e-4 (slot stats 1e-5); two launches bit-identical; each
launch counted under the instance's ``_bf16`` name; a bf16 backward
launching the bf16 backward instances.

Marked ``cuda``; each test skips unless a CUDA card is visible. Run on a
machine with a card with::

    python -m pytest tests/test_torch_cuda_bf16.py -m cuda -q --noconftest
"""

import pytest
import torch

from torch_port_util import bf16_ulps

from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import (gate_reference, tail,
                                                       tail_kernel,
                                                       tail_reference)
from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head, head_operands,
                                                  head_reference_given_idx)
from pdgn_tpu_torch.ops.kernels.knn import knn_topk
from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                   stats_plain)

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
HEAD_WEIGHTS, TAIL_WEIGHTS = (2, 3, 5, 6), (5, 9)


def _bf16_weights(args, at):
    """The fp32 weights at ``at`` of ``edge_head``'s or ``tail``'s operands
    rounded to bf16, as the wrappers hand them to the kernels and the
    plain versions."""
    return [a.to(BF) if i in at and a is not None else a
            for i, a in enumerate(args)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-12))


def _head_args(dev, N, C, cx, k, gated, four_fin=None, two_f=None):
    g = torch.Generator(device=dev).manual_seed(N + k + C)
    B, cf = 3, C + cx
    four_fin = four_fin or 4 * cf
    two_f = two_f or 2 * cf
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C).to(BF)
    xs = r(B, cx).to(BF) if cx else None
    ops = head_operands(x, r(1, window, 2 * cf, four_fin) * 0.1,
                        r(four_fin) * 0.1, r(2 * k * 2 * cf, two_f) * 0.05,
                        k, xs)
    x_knn, wn, ca, pb, am, wen, pbm, window = ops
    pcat = r(B, N, 32).to(BF) if gated else None
    ppoint = r(B, N, 32).to(BF) if gated else None
    return x, x_knn, wn, ca, pb, am, wen, pbm, pcat, ppoint, k, window


@pytest.mark.parametrize("N,C,cx,k,gated,four_fin,two_f", [
    (100, 40, 0, 6, False, None, None),
    (130, 24, 16, 10, True, None, None),
    (256, 128, 128, 10, True, None, None),
    (200, 36, 8, 14, True, None, None),       # C off a multiple of 8
    (150, 16, 16, 18, False, None, None),
    (160, 8, 8, 126, True, None, None),
    (128, 32, 0, 10, False, 130, 66)])        # scalar gather columns
def test_bf16_head_matches_plain(dev, N, C, cx, k, gated, four_fin, two_f):
    args = _head_args(dev, N, C, cx, k, gated, four_fin, two_f)
    before = _lib.LAUNCHES["edge_head_bf16"]
    got = edge_head(*args)
    again = edge_head(*args)
    assert _lib.LAUNCHES["edge_head_bf16"] == before + 2
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    x_knn = args[1].float()
    assert torch.equal(got[0], knn_topk(x_knn, x_knn, k + 1)[..., 1:])
    want = head_reference_given_idx(
        args[0], *_bf16_weights(args, HEAD_WEIGHTS)[2:10], got[0], k,
        args[11])
    for a, b in zip(got[1:], want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        if a.dtype == BF:
            assert bf16_ulps(a, b) <= 2.0
        else:
            assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("rows,k", [(1, 2), (1000, 10), (5003, 18)])
def test_bf16_slot_stats_matches_plain(dev, rows, k):
    h = torch.randn(1, rows, k * 64, device=dev).to(BF)
    s, S = slot_moment_stats(h, k)
    s_p, S_p = stats_plain(h, k)
    assert s.dtype == S.dtype == torch.float32
    assert _rel(s, s_p) <= 1e-5 and _rel(S, S_p) <= 1e-5
    s2, S2 = slot_moment_stats(h, k)
    assert torch.equal(s, s2) and torch.equal(S, S2)


def _tail_args(dev, gated, k, fin, N=37, four_fin=None, two_f=None):
    g = torch.Generator(device=dev).manual_seed(k * fin + N)
    B = 2
    four_fin = four_fin or 4 * fin
    two_f = two_f or 2 * fin
    hk, two_fin = k // 2, four_fin // 2

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    return [r(B, N, two_f), r(B, N, hk * four_fin).to(BF),
            (r(B, N, k * 64) * 0.5).to(BF) if gated else None,
            r(four_fin) * 0.2 + 1, r(four_fin) * 0.1,
            r(64, two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.2 + 1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(hk * four_fin, two_f) * 0.05, r(two_f) * 0.1, k, True]


@pytest.mark.parametrize("gated,k,fin,N,four_fin,two_f", [
    (True, 10, 12, 37, None, None), (False, 10, 8, 37, None, None),
    (True, 18, 12, 37, None, None), (True, 126, 4, 37, None, None),
    (False, 30, 8, 37, None, None), (True, 10, 0, 135, 130, 66),
    (False, 10, 0, 135, 130, 66)])
def test_bf16_tail_matches_plain(dev, gated, k, fin, N, four_fin, two_f):
    """The gate g within 2 ulps of ``gate_reference``'s, y within 1 ulp of
    the bf16 rounding of the float64 merge of the kernel's own g, and at
    most 1% of y differing from the plain version's (chip_smoke phase
    2b's rule)."""
    args = _tail_args(dev, gated, k, fin, N, four_fin, two_f)
    name = "bilateral_tail_" + ("gated" if gated else "plain") + "_bf16"
    before = _lib.LAUNCHES[name]
    kargs = _bf16_weights(args, TAIL_WEIGHTS)
    y, g = tail_kernel(*kargs, keep_g=True)
    assert _lib.LAUNCHES[name] == before + 1
    assert y.dtype == g.dtype == BF
    assert torch.equal(y, tail(*args))
    partial, wi, bias = kargs[0], kargs[9], kargs[10]
    B, N, two_f = partial.shape
    g_p = gate_reference(*kargs[1:9], k, True).reshape(B * N, -1)
    assert bf16_ulps(g, g_p) <= 2.0
    y64 = (partial.double().reshape(B * N, two_f) + g.double() @ wi.double()
           + bias.double()).to(BF).reshape(B, N, two_f)
    assert bf16_ulps(y, y64) <= 1.0
    assert float((y != tail_reference(*kargs)).float().mean()) <= 1e-2


def test_bf16_instances_refuse_a_backward(dev):
    """bf16 training is ported: a bf16 head's and tail's backward launch
    their bf16 instances (``_bwd_bf16``), never an fp32 one through a
    cast; tests/test_torch_cuda_bf16_train.py holds them to their plain
    versions. The name is kept from when a bf16 backward was refused."""
    args = _head_args(dev, 64, 16, 0, 6, True)
    x = args[0].clone().requires_grad_(True)
    out = edge_head(x, *args[1:])
    before = dict(_lib.LAUNCHES)
    out[2].sum().backward()
    assert _lib.LAUNCHES["edge_head_bwd_bf16"] == before.get(
        "edge_head_bwd_bf16", 0) + 1
    assert _lib.LAUNCHES["edge_head_bwd"] == before.get("edge_head_bwd", 0)
    assert x.grad.dtype == BF
    targs = _tail_args(dev, True, 10, 8)
    targs[0].requires_grad_(True)
    y = tail(*targs)
    before = dict(_lib.LAUNCHES)
    y.float().sum().backward()
    name = "bilateral_tail_gated_bwd"
    assert _lib.LAUNCHES[name + "_bf16"] == before.get(name + "_bf16", 0) + 1
    assert _lib.LAUNCHES[name] == before.get(name, 0)
    assert targs[0].grad.dtype == torch.float32
