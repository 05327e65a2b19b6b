"""The bf16 instances of the port's backward kernels (the edge head's and
both tails': ``--phase train --compute_dtype bfloat16``) against their bf16
plain versions on the card, at small and ragged shapes that ``chip_smoke``
phase 2bt's full-width checks never hit: row counts that fill no tile,
channel counts off multiples of 8 (a 16-byte granule of bf16), k from 2 to
126, 4Fin and 2F off multiples of 8, 2Fin odd, and (the head backward)
graphs of hub rows whose lists outgrow the d_x kernel's shared-memory hit
list. bf16 outputs within 2 ulps
of the larger magnitude, counted at no less than 1/256 of the largest
(``torch_port_util.bf16_ulps``, phase 2b's measure and limit); fp32
outputs rel <= 1e-4; two launches bit-identical; each launch counted under
the instance's ``_bf16`` name. The tails' products are held to the
float64 products of the kernel's own bf16 operands, and those operands to
the plain version's, the gated tail's slot-logit entries at a kink
(``kink_mask``) left out (chip_smoke phase 2bt's rule).

Marked ``cuda``; each test skips unless a CUDA card is visible. Run on a
machine with a card with::

    python -m pytest tests/test_torch_cuda_bf16_train.py -m cuda -q --noconftest
"""

import pytest
import torch

from torch_port_util import bf16_ulps

from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import (TAIL_BWD_FAST_K,
                                                       kink_mask,
                                                       tail_bwd_kernel_bf16,
                                                       tail_bwd_plain_bf16)
from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                  head_bwd_kernel,
                                                  head_bwd_plain_bf16,
                                                  head_operands)

pytestmark = pytest.mark.cuda

BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-12))


def _check(got, want, rows_ok=None):
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if rows_ok is not None and i in rows_ok:
            keep = rows_ok[i]
            a = a.reshape(keep.numel(), -1)[keep]
            b = b.reshape(keep.numel(), -1)[keep]
        if a.dtype == BF:
            assert bf16_ulps(a, b) <= 2.0, (i, bf16_ulps(a, b))
        else:
            assert _rel(a, b) <= 1e-4, (i, _rel(a, b))


@pytest.mark.parametrize("N,C,cx,k,gated,four_fin,two_f", [
    (100, 40, 0, 6, False, None, None),
    (130, 24, 16, 10, True, None, None),
    (256, 128, 128, 10, True, None, None),
    (200, 36, 8, 14, True, None, None),       # C off a multiple of 8
    (150, 16, 16, 18, False, None, None),
    (160, 8, 8, 126, True, None, None),
    (128, 32, 0, 10, False, 130, 66),         # 4Fin, 2F off multiples of 8
    (37, 24, 0, 10, True, None, None),        # 111 rows: no tile filled
    (90, 16, 8, 2, True, None, None)])        # k = 2
def test_bf16_head_bwd_matches_plain(dev, N, C, cx, k, gated, four_fin,
                                     two_f):
    g = torch.Generator(device=dev).manual_seed(N + k + C)
    B, cf = 3, C + cx
    four_fin = four_fin or 4 * cf
    two_f = two_f or 2 * cf

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C).to(BF)
    xs = r(B, cx).to(BF) if cx else None
    window = k // 2 + 1
    ops = head_operands(x, r(1, window, 2 * cf, four_fin) * 0.1,
                        r(four_fin) * 0.1, r(2 * k * 2 * cf, two_f) * 0.05,
                        k, xs)
    x_knn, wn, ca, pb, am, wen, pbm, window = ops
    pcat = r(B, N, 32).to(BF) if gated else None
    ppoint = r(B, N, 32).to(BF) if gated else None
    idx, inte = edge_head(x, x_knn, wn, ca, pb, am, wen, pbm, pcat, ppoint,
                          k, window)[:2]
    cts = [r(*inte.shape).to(BF), r(B, N, two_f).to(BF).float(),
           r(2, four_fin) * 0.01]
    if gated:
        cts += [r(B, N, k * 16).to(BF), r(B, N, k * 16).to(BF),
                r(2, k * 32) * 0.01]
    else:
        cts += [None] * 3
    before = _lib.LAUNCHES["edge_head_bwd_bf16"]
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                          k)
    again = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                            k)
    assert _lib.LAUNCHES["edge_head_bwd_bf16"] == before + 2
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    assert got[0].dtype == BF and got[1].dtype == torch.float32
    want = head_bwd_plain_bf16(x, idx, inte, wn, ca, am, wen, pcat, ppoint,
                               cts, k, window)
    _check(got, want)


@pytest.mark.parametrize("N,C,four_fin,two_f,gated", [
    (300, 40, 130, 66, True),     # hubs within the d_x kernel's hit list
    (2048, 32, 128, 64, False)])  # a window's hits beyond it
def test_bf16_head_bwd_hub_rows(dev, N, C, four_fin, two_f, gated):
    """A graph of hub rows: every row names rows 0..k-1 (those rows name
    k..2k-1), so the first tile's lists hold nearly all of the cloud's
    entries and are cut between the d_x kernel's producer warps; at N=2048
    a window's hits outgrow its shared-memory list and the kernel walks the
    reverse adjacency. Against ``head_bwd_plain_bf16``; two launches
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(N + C)
    B, k = 2, 10
    hk, window = k // 2, k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    idx = torch.arange(k, device=dev).repeat(B, N, 1)
    idx[:, :k] += k
    idx = idx.int().contiguous()
    x = r(B, N, C).to(BF)
    wn, ca = r(window * C, four_fin) * 0.1, r(C, four_fin) * 0.1
    am, wen = r(C, two_f) * 0.1, r(k * C, two_f) * 0.1
    inte = r(B, N, hk * four_fin).to(BF)
    pcat = r(B, N, 32).to(BF) if gated else None
    ppoint = r(B, N, 32).to(BF) if gated else None
    cts = [r(B, N, hk * four_fin).to(BF), r(B, N, two_f).to(BF).float(),
           r(2, four_fin) * 0.01]
    cts += ([r(B, N, k * 16).to(BF), r(B, N, k * 16).to(BF),
             r(2, k * 32) * 0.01] if gated else [None] * 3)
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                          k)
    again = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                            k)
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    _check(got, head_bwd_plain_bf16(x, idx, inte, wn, ca, am, wen, pcat,
                                    ppoint, cts, k, window))


@pytest.mark.parametrize("gated,k,fin,N,four_fin,two_f", [
    (True, 10, 12, 37, None, None), (False, 10, 8, 37, None, None),
    (True, 18, 12, 37, None, None), (True, 126, 4, 37, None, None),
    (False, 30, 8, 37, None, None), (True, 10, 0, 135, 130, 66),
    (False, 10, 0, 135, 130, 66),
    (True, 34, 12, 37, None, None),       # the core's chain past k = 16
    (True, 14, 0, 37, 130, 66),           # the fast route, 16 slots
    (True, 10, 64, 256, None, None)])     # stage 2's widths
def test_bf16_tail_bwd_matches_plain(dev, gated, k, fin, N, four_fin, two_f):
    """Each rounded operand (d_inte, the d_wi operand g, the d_h and d_w2k
    operand dv) within 2 ulps of the plain version's, dv on the (point,
    slot) rows free of kinks; each product against the float64 product of
    the kernel's own operands (d_h within 1 ulp, d_wi and d_w2k rel <=
    1e-4); the sums rel <= 1e-4 of the plain version's (chip_smoke phase
    2bt's rule). The gated stage counts its fused kernel (k <= 16) and the
    core's chain at wider k under their own names."""
    g = torch.Generator(device=dev).manual_seed(k * fin + N)
    B = 2
    four_fin = four_fin or 4 * fin
    two_f = two_f or 2 * fin
    hk, two_fin = k // 2, four_fin // 2

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    args = [r(B, N, hk * four_fin).to(BF),
            (r(B, N, k * 64) * 0.5).to(BF) if gated else None,
            r(four_fin) * 0.2 + 1, r(four_fin) * 0.1,
            r(64, two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.2 + 1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(hk * four_fin, two_f) * 0.05]
    dy = r(B, N, two_f).to(BF)
    wide = gated and k > TAIL_BWD_FAST_K
    name = ("bilateral_tail_" + ("gated" if gated else "plain") + "_bwd"
            + ("_wide" if wide else "") + "_bf16")
    before = _lib.LAUNCHES[name]
    keep = dict(keep_g=True, keep_dv=True)
    got = tail_bwd_kernel_bf16(*args, dy, k, True, **keep)
    again = tail_bwd_kernel_bf16(*args, dy, k, True, **keep)
    assert _lib.LAUNCHES[name] == before + 2
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    want = tail_bwd_plain_bf16(*args, dy, k, True, **keep)
    rows = B * N
    assert bf16_ulps(got[1], want[1]) <= 2.0
    assert bf16_ulps(got[11], want[11]) <= 2.0
    assert _rel(got[9], got[11].double().T
                @ dy.reshape(rows, -1).double()) <= 1e-4
    for i in (0, 3, 4, 10):
        assert got[i].dtype == torch.float32
        assert _rel(got[i], want[i]) <= 1e-4, i
    if not gated:
        assert got[2] is None and len(got) == 12
        return
    dv = got[12]
    ok = ~kink_mask(args[1], *args[4:8], k).any(-1)
    assert bf16_ulps(dv[ok], want[12][ok]) <= 2.0
    w2k = args[4].to(BF).double()
    assert bf16_ulps(got[2].reshape(rows, k, 64),
                     (dv.double() @ w2k.T).to(BF)) <= 1.0
    h = args[1].reshape(rows, k, 64).double()
    assert _rel(got[5], torch.einsum("rsh,rsc->hc", h, dv.double())) <= 1e-4
    for i in (6, 7, 8):
        assert _rel(got[i], want[i]) <= 1e-4, i
