"""The bf16 instances of the port's forward kernels (edge head, slot stats,
both tails: ``--compute_dtype bfloat16``) against their bf16 plain
versions, on the card, at small and ragged shapes that the full-width
checks of ``chip_smoke.py`` phase 2b never hit: row counts that fill no
tile, channel counts off multiples of 8 (a 16-byte granule of bf16, so
``x``, ``wi`` and ``g`` are padded), k from 6 to 126, 2Fin odd (the gate
stages those channels by plain loads). The gather-first head's own tile
edges: 63, 64, 65 and 1,000 rows against its 128-row tiles, C padded to
its 64-channel slabs, 4Fin and 2F off its 256-column tiles (odd: scalar
stores), k = 2 and 126, plain and gated, and no product scratch at a
stage-4 shape. The fused gated tail's own tile edges: 127, 128, 129 and
1,000 rows against its 64-row tiles, 2F of 66 and 258 against its
256-column tiles, 514 and 1030 past its 512-column items, k = 2, 10, 18
and 126, 2Fin = 65 against its 32-channel slabs, and no g scratch at a
stage-4 shape. bf16 outputs within 2 ulps of
the larger magnitude, counted at no less than 1/256 of the largest
(``torch_port_util.bf16_ulps``, phase 2b's measure and limit; the tails'
y held to the float64 merge of their own g, as phase 2b holds it: the
fused gated kernel writes its g only when a check asks, ``probe_g``); fp32
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
                                                       tail_bwd_kernel_bf16,
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


def _head_args(dev, N, C, cx, k, gated, four_fin=None, two_f=None, B=3):
    g = torch.Generator(device=dev).manual_seed(N + k + C)
    cf = C + cx
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


def _head_matches_plain(args):
    """Two launches bit-identical and counted, the graph knn_topk's of the
    fp32 upcast, the rest against the plain version on that graph: bf16
    outputs within 2 ulps, fp32 outputs rel <= 1e-4."""
    k = args[10]
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


@pytest.mark.parametrize("N,C,cx,k,gated,four_fin,two_f", [
    (100, 40, 0, 6, False, None, None),
    (130, 24, 16, 10, True, None, None),
    (256, 128, 128, 10, True, None, None),
    (200, 36, 8, 14, True, None, None),       # C off a multiple of 8
    (150, 16, 16, 18, False, None, None),
    (160, 8, 8, 126, True, None, None),
    (128, 32, 0, 10, False, 130, 66)])        # scalar gather columns
def test_bf16_head_matches_plain(dev, N, C, cx, k, gated, four_fin, two_f):
    _head_matches_plain(_head_args(dev, N, C, cx, k, gated, four_fin, two_f))


@pytest.mark.parametrize("B,N,C,cx,k,gated,four_fin,two_f", [
    (1, 63, 64, 0, 10, True, None, None),     # rows that fill no tile
    (1, 64, 64, 0, 10, False, None, None),    # half a tile
    (1, 65, 128, 0, 10, True, None, None),
    (1, 1000, 128, 128, 10, True, None, None),
    (2, 300, 96, 32, 10, True, 300, 130),     # off the 256-column tiles
    (2, 200, 40, 0, 10, False, 257, 129),     # odd: scalar stores
    (2, 100, 32, 0, 2, True, None, None),     # k = 2
    (2, 200, 32, 0, 2, False, None, None),
    (1, 200, 64, 0, 126, True, None, None),   # k = 126: depth 64 slots
    (1, 160, 24, 8, 126, False, None, None)])
def test_bf16_head_tile_edges(dev, B, N, C, cx, k, gated, four_fin, two_f):
    _head_matches_plain(_head_args(dev, N, C, cx, k, gated, four_fin, two_f,
                                   B=B))


def test_bf16_head_allocates_no_product_scratch(dev):
    """At stage 4 (N=1024, C=128+128, k=10), B=32, the memory one bf16 head
    call takes beyond its inputs and outputs is below an eighth of the
    product scratch P that the P-first design allocated for its first
    chunk of clouds (fp32 rows of the packed W_all, at most 1 GiB)."""
    B, N, C, cx, k = 32, 1024, 128, 128, 10
    args = _head_args(dev, N, C, cx, k, True, B=B)
    four_fin, two_f, window = 4 * (C + cx), 2 * (C + cx), k // 2 + 1
    ld = _lib.up8((window + 1) * four_fin + (k + 1) * two_f)
    chunk_bytes = min(B, (1 << 30) // (N * ld * 4)) * N * ld * 4
    edge_head(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = edge_head(*args)
    torch.cuda.synchronize()
    outs = sum(o.numel() * o.element_size() for o in out if o is not None)
    scratch = torch.cuda.max_memory_allocated() - base - outs
    assert scratch < chunk_bytes / 8, (scratch, chunk_bytes)


@pytest.mark.parametrize("rows,k", [(1, 2), (1000, 10), (5003, 18),
                                    (40000, 10)])
def test_bf16_slot_stats_matches_plain(dev, rows, k):
    h = torch.randn(1, rows, k * 64, device=dev).to(BF)
    s, S = slot_moment_stats(h, k)
    s_p, S_p = stats_plain(h, k)
    assert s.dtype == S.dtype == torch.float32
    assert _rel(s, s_p) <= 1e-5 and _rel(S, S_p) <= 1e-5
    s2, S2 = slot_moment_stats(h, k)
    assert torch.equal(s, s2) and torch.equal(S, S2)


def _tail_args(dev, gated, k, fin, N=37, four_fin=None, two_f=None, B=2):
    g = torch.Generator(device=dev).manual_seed(k * fin + N)
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


def _tail_matches_plain(args, name):
    """The gate g within 2 ulps of ``gate_reference``'s, y within 1 ulp of
    the bf16 rounding of the float64 merge of the kernel's own g (the
    gated kernel's g as it made it, ``probe_g``: it writes none otherwise;
    at most 0.1% of y differing there), and at most 1% of y differing
    from the plain version's (chip_smoke phase 2b's rule); the gated
    kernel's y with and without the probe equal, and the bf16 backward's
    own g (``tail_bwd_kernel_bf16(..., keep_g=True)``, (gi * w) rounded
    once) within 2 ulps of ``gate_reference``'s."""
    gated = args[2] is not None
    k = args[11]
    before = _lib.LAUNCHES[name]
    kargs = _bf16_weights(args, TAIL_WEIGHTS)
    if gated:
        with pytest.raises(ValueError, match="writes no g"):
            tail_kernel(*kargs, keep_g=True)
        y, g = tail_kernel(*kargs, probe_g=True)
        assert torch.equal(y, tail_kernel(*kargs))
        assert _lib.LAUNCHES[name] == before + 2
    else:
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
    if gated:
        assert float((y != y64).float().mean()) <= 1e-3
        dy = torch.zeros_like(y)
        g_bwd = tail_bwd_kernel_bf16(*kargs[1:10], dy, k, True,
                                     keep_g=True)[11]
        assert bf16_ulps(g_bwd, g_p) <= 2.0
    assert float((y != tail_reference(*kargs)).float().mean()) <= 1e-2


@pytest.mark.parametrize("gated,k,fin,N,four_fin,two_f", [
    (True, 10, 12, 37, None, None), (False, 10, 8, 37, None, None),
    (True, 18, 12, 37, None, None), (True, 126, 4, 37, None, None),
    (False, 30, 8, 37, None, None), (True, 10, 0, 135, 130, 66),
    (False, 10, 0, 135, 130, 66)])
def test_bf16_tail_matches_plain(dev, gated, k, fin, N, four_fin, two_f):
    name = "bilateral_tail_" + ("gated" if gated else "plain") + "_bf16"
    _tail_matches_plain(_tail_args(dev, gated, k, fin, N, four_fin, two_f),
                        name)


@pytest.mark.parametrize("B,N,k,four_fin,two_f", [
    (1, 127, 10, 64, 66), (1, 128, 2, 130, 258), (1, 129, 18, 96, 66),
    (2, 500, 126, 8, 258), (1, 1000, 10, 130, 258), (3, 43, 14, 48, 24),
    (1, 200, 10, 130, 514), (1, 129, 18, 96, 1030)])
def test_bf16_gated_tail_tile_edges(dev, B, N, k, four_fin, two_f):
    """The fused kernel at its tiles' edges: rows that fill no 64-row
    tile, 2F off its 256-column tiles and past one 512-column item (514
    and 1030: two and three column items a row tile), 2Fin off its
    32-channel slabs, k in each of its gate's three instances (k <= 10,
    <= 16, the two-pass wider one); two launches bit-identical."""
    args = _tail_args(dev, True, k, 0, N, four_fin, two_f, B=B)
    _tail_matches_plain(args, "bilateral_tail_gated_bf16")
    kargs = _bf16_weights(args, TAIL_WEIGHTS)
    assert torch.equal(tail_kernel(*kargs), tail_kernel(*kargs))


def test_bf16_gated_tail_allocates_no_g(dev):
    """At stage 4 (N=1024, 4Fin=1024, 2F=512, k=10), B=32, the memory one
    fused bf16 gated tail call takes beyond its inputs and its output is
    below an eighth of the g scratch (rows x ldg bf16) that the two-launch
    design allocated."""
    B, N, k, fin = 32, 1024, 10, 256
    args = _tail_args(dev, True, k, fin, N, B=B)
    g_bytes = B * N * _lib.up8(k // 2 * 4 * fin) * 2
    tail(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = tail(*args)
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - base
               - y.numel() * y.element_size())
    assert scratch < g_bytes / 8, (scratch, g_bytes)


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
