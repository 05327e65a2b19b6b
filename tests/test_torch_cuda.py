"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (edges that the full-width checks of
``chip_smoke.py`` never hit: row counts that fill no tile, channel counts
that are no multiple of a chunk, k other than 10).

The widened shapes too: the head at any even k with k + 1 <= 128 and at
4Fin or 2F that are no multiple of 4, the gated tail at k > 16, local
statistics at any k <= 128 and N up to 65,536, emd_cd at any n, and a
full-width generator at num_k 28. The 3xTF32 gated tail, its backward and
the head backward at ragged row counts and widths off multiples of 4,
twice (bit-identical); the g that the tail backward's gate pass writes
equal to the forward's under ``torch.equal``; the head forward's digest
from before its product moved into the shared product core; and that core
alone at its longest folded chains.

Marked ``cuda``; each test skips unless a CUDA card is visible (decided in
the fixture, never at import). Run on a machine with a card with::

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import tail, tail_reference
from pdgn_tpu_torch.ops.kernels.edge_head import (HEAD_BITS, edge_head,
                                                  head_bits, head_operands,
                                                  head_reference_given_idx)
from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                   stats_plain)
from pdgn_tpu_torch.ops.knn import knn_exclude_first
from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-12))


@pytest.mark.parametrize("N,C,cx,k,gated", [(100, 40, 0, 6, False),
                                            (130, 24, 16, 10, True),
                                            (64, 32, 32, 16, True),
                                            (128, 32, 0, 10, False),
                                            (256, 128, 128, 10, True),
                                            (200, 24, 8, 14, True),
                                            (150, 16, 16, 18, False),
                                            (160, 8, 8, 126, True)])
def test_edge_head_kernel_matches_plain(dev, N, C, cx, k, gated):
    g = torch.Generator(device=dev).manual_seed(N + k)
    B, four_fin, two_f = 3, 4 * (C + cx), 2 * (C + cx)
    cf = C + cx
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C)
    xs = r(B, cx) if cx else None
    ops = head_operands(x, r(1, window, 2 * cf, four_fin) * 0.1,
                        r(four_fin) * 0.1, r(2 * k * 2 * cf, two_f) * 0.05,
                        k, xs)
    x_knn, wn, ca, pb, am, wen, pbm, window = ops
    pcat = r(B, N, 32) if gated else None
    ppoint = r(B, N, 32) if gated else None
    before = _lib.LAUNCHES["edge_head"]
    got = edge_head(x, x_knn, wn, ca, pb, am, wen, pbm, pcat, ppoint, k,
                    window)
    assert _lib.LAUNCHES["edge_head"] == before + 1
    idx_p = knn_exclude_first(self_pairwise_sqdist(x_knn), k)
    assert float((got[0] != idx_p).float().mean()) <= 1e-3
    # the head's graph is knn_topk's selection (norm expansion, C > 4)
    from pdgn_tpu_torch.ops.kernels.knn import knn_topk
    assert torch.equal(got[0], knn_topk(x_knn, x_knn, k + 1)[..., 1:])
    want = head_reference_given_idx(x, wn, ca, pb, am, wen, pbm, pcat,
                                    ppoint, got[0], k, window)
    for a, b in zip(got[1:], want):
        if b is None:
            assert a is None
        else:
            assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("rows", [1, 1000, 5000])
def test_slot_stats_kernel_matches_plain(dev, rows):
    h = torch.randn(1, rows, 2 * 64, device=dev)
    s, S = slot_moment_stats(h, 2)
    s_p, S_p = stats_plain(h, 2)
    assert _rel(s, s_p) <= 1e-5 and _rel(S, S_p) <= 1e-5


def test_edge_head_kernel_reruns_are_bit_identical(dev):
    """Two launches on the same inputs (stage-4 widths, gated, the batch cut
    into chunks of two clouds) give the same bits in every output, and the
    chunked and the whole batch both match the plain version."""
    from pdgn_tpu_torch.ops.kernels import edge_head as eh

    g = torch.Generator(device=dev).manual_seed(5)
    B, N, C, cx, k = 5, 256, 128, 128, 10
    cf = C + cx
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C)
    ops = head_operands(x, r(1, window, 2 * cf, 4 * cf) * 0.05,
                        r(4 * cf) * 0.1, r(2 * k * 2 * cf, 2 * cf) * 0.03,
                        k, r(B, cx))
    args = (x,) + ops[:7] + (r(B, N, 32), r(B, N, 32), k, window)
    budget = eh._P_BUDGET
    try:
        eh._P_BUDGET = 2 * N * 12800 * 4          # two clouds a chunk
        first = edge_head(*args)
        second = edge_head(*args)
    finally:
        eh._P_BUDGET = budget
    whole = edge_head(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(first[0], whole[0])
    want = head_reference_given_idx(args[0], *args[2:10], first[0], k,
                                    window)
    for a, c, w in zip(first[1:], whole[1:], want):
        assert _rel(a, w) <= 1e-4 and _rel(c, w) <= 1e-4


def test_edge_head_kernel_refuses_what_it_cannot_take(dev):
    """k + 1 neighbours are at most 128 (knn_select's longest list)."""
    B, N, C, k = 2, 200, 8, 128
    window = k // 2 + 1
    x = torch.randn(B, N, C, device=dev)
    ops = head_operands(x, torch.randn(1, window, 2 * C, 8, device=dev),
                        torch.randn(8, device=dev),
                        torch.randn(2 * k * 2 * C, 8, device=dev), k)
    with pytest.raises(ValueError, match="MAX_K"):
        edge_head(x, *ops[:7], None, None, k, window)


@pytest.mark.parametrize("k,gated", [(6, False), (10, True), (22, True)])
def test_edge_head_kernel_takes_widths_off_float4(dev, k, gated):
    """4Fin = 6 and 2F = 10 (no multiples of 4) take scalar columns, at an
    unrolled k and at the run-time one, and match the plain version."""
    g = torch.Generator(device=dev).manual_seed(k)
    B, N, C = 2, 64, 8
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C)
    ops = head_operands(x, r(1, window, 2 * C, 6) * 0.1, r(6) * 0.1,
                        r(2 * k * 2 * C, 10) * 0.05, k)
    pcat = r(B, N, 32) if gated else None
    ppoint = r(B, N, 32) if gated else None
    got = edge_head(x, *ops[:7], pcat, ppoint, k, window)
    want = head_reference_given_idx(x, *ops[1:7], pcat, ppoint, got[0], k,
                                    window)
    for a, b in zip(got[1:], want):
        if b is None:
            assert a is None
        else:
            assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("rows", [132 * 8 * 16 + 5, 200_000])
def test_slot_stats_kernel_partition_edges(dev, rows):
    """Row counts that fill no whole partition of the persistent grid (132
    blocks of 8 warps, 16-row stages) and 200,000 rows; S exactly
    symmetric, reruns bit-identical."""
    h = torch.randn(rows, 1, 64, device=dev)
    s, S = slot_moment_stats(h, 1)
    s_p, S_p = stats_plain(h, 1)
    assert _rel(s, s_p) <= 1e-5 and _rel(S, S_p) <= 1e-5
    assert torch.equal(S, S.T)
    s2, S2 = slot_moment_stats(h, 1)
    assert torch.equal(s, s2) and torch.equal(S, S2)


@pytest.mark.parametrize("gated,softmax,k,fin", [(True, True, 10, 12),
                                                 (True, False, 6, 40),
                                                 (False, True, 10, 8),
                                                 (True, True, 18, 12),
                                                 (True, False, 40, 8),
                                                 (True, True, 126, 4),
                                                 (False, True, 30, 8)])
def test_tail_kernel_matches_plain(dev, gated, softmax, k, fin):
    g = torch.Generator(device=dev).manual_seed(k * fin)
    B, N, two_f = 2, 37, 2 * fin
    hk, four_fin, two_fin = k // 2, 4 * fin, 2 * fin

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    args = [r(B, N, two_f), r(B, N, hk * four_fin),
            r(B, N, k * 64) * 0.5 if gated else None,
            r(four_fin) * 0.2 + 1, r(four_fin) * 0.1,
            r(64, two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.2 + 1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(hk * four_fin, two_f) * 0.05, r(two_f) * 0.1, k, softmax]
    assert _rel(tail(*args), tail_reference(*args)) <= 1e-4


def test_generate_on_the_card_matches_shapes(dev):
    from pdgn_tpu_torch.train.generate import generate

    _lib.LAUNCHES.clear()
    clouds = generate(6, 3, seed=1, device="cuda", base_points=16)
    assert clouds.shape == (6, 256, 3) and np.isfinite(clouds).all()
    assert dict(_lib.LAUNCHES) == {"edge_head": 8, "slot_stats": 6,
                                   "bilateral_tail_gated": 6,
                                   "bilateral_tail_plain": 2}


@pytest.mark.parametrize("N,C,cx,k,gated", [(100, 40, 0, 6, False),
                                            (130, 24, 16, 10, True),
                                            (64, 32, 32, 16, True),
                                            (200, 24, 8, 14, True),
                                            (150, 16, 16, 18, True),
                                            (140, 8, 0, 30, False)])
def test_edge_head_backward_kernel_matches_plain(dev, N, C, cx, k, gated):
    """Given the same graph and the same random cotangents, every gradient
    of the head's backward kernel rel <= 1e-4 of autograd's."""
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(7 * N + k)
    B, four_fin, two_f = 3, 4 * (C + cx), 2 * (C + cx)
    cf = C + cx
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C)
    xs = r(B, cx) if cx else None
    x_knn, wn, ca, pb, am, wen, pbm, window = head_operands(
        x, r(1, window, 2 * cf, four_fin) * 0.1, r(four_fin) * 0.1,
        r(2 * k * 2 * cf, two_f) * 0.05, k, xs)
    pcat = r(B, N, 32) if gated else None
    ppoint = r(B, N, 32) if gated else None
    idx, inte = edge_head(x, x_knn, wn, ca, pb, am, wen, pbm, pcat, ppoint,
                          k, window)[:2]
    cts = [r(*inte.shape), r(B, N, two_f), r(2, four_fin) * 0.01]
    if gated:
        cts += [r(B, N, k * 16), r(B, N, k * 16), r(2, k * 32) * 0.01]
    before = _lib.LAUNCHES["edge_head_bwd"]
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts, k)
    assert _lib.LAUNCHES["edge_head_bwd"] == before + 1
    want = head_bwd_plain(x, idx, wn, ca, pb, am, wen, pbm, pcat, ppoint,
                          cts, k, window)
    names = ("x", "wn_flat", "conv_a", "pb_point", "a_merge", "wen",
             "pb_merge", "pcat", "ppoint")
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
        else:
            assert a.shape == b.shape, name
            assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


@pytest.mark.parametrize("gated,softmax,k,fin", [(True, True, 10, 12),
                                                 (True, False, 6, 40),
                                                 (False, True, 10, 8),
                                                 (True, True, 18, 12),
                                                 (True, False, 40, 8),
                                                 (True, True, 126, 4)])
def test_tail_backward_kernel_matches_plain(dev, gated, softmax, k, fin):
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(3 * k * fin)
    B, N, two_f = 2, 37, 2 * fin
    hk, four_fin, two_fin = k // 2, 4 * fin, 2 * fin

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    args = [r(B, N, two_f), r(B, N, hk * four_fin),
            r(B, N, k * 64) * 0.5 if gated else None,
            r(four_fin) * 0.2 + 1, r(four_fin) * 0.1,
            r(64, two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.2 + 1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(hk * four_fin, two_f) * 0.05, r(two_f) * 0.1]
    dy = r(B, N, two_f)
    got = tail_bwd_kernel(*args[1:10], dy, k, softmax)
    want = tail_bwd_plain(*args, dy, k, softmax)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        else:
            assert _rel(a, b) <= 1e-4, (i, _rel(a, b))


def _odd_tail_args(g, dev, gated, k, B=3, N=45, four_fin=130, two_f=66):
    hk, two_fin = k // 2, four_fin // 2

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    return [r(B, N, two_f), r(B, N, hk * four_fin),
            r(B, N, k * 64) * 0.5 if gated else None,
            r(four_fin) * 0.2 + 1, r(four_fin) * 0.1,
            r(64, two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(two_fin) * 0.2 + 1 if gated else None,
            r(two_fin) * 0.1 if gated else None,
            r(hk * four_fin, two_f) * 0.05, r(two_f) * 0.1, k, True]


@pytest.mark.parametrize("gated,k", [(True, 10), (True, 18), (False, 10)])
def test_tail_kernel_ragged_rows_and_odd_widths(dev, gated, k):
    """135 rows (no whole 128-row tile of the merge, no whole 16-point tile
    of the gate), 4Fin = 130 and 2F = 66 (wi and g padded to multiples of
    4; 2Fin = 65 is odd), k = 10 and the wide gate's 18: rel <= 1e-4 of the
    plain version, two launches bit-identical."""
    args = _odd_tail_args(torch.Generator(device=dev).manual_seed(11 * k),
                          dev, gated, k)
    y = tail(*args)
    assert torch.equal(y, tail(*args))
    assert _rel(y, tail_reference(*args)) <= 1e-4


@pytest.mark.parametrize("gated,k", [(True, 10), (True, 16), (True, 18),
                                     (False, 10)])
def test_tail_backward_ragged_rows_and_odd_widths(dev, gated, k):
    """The backward at 135 rows, 4Fin = 130, 2F = 66 and odd 2Fin = 65
    (dy, wi^T, g, dg and dv padded to multiples of 4 for the products),
    k = 10, 16 and the wide gate's 18: every gradient rel <= 1e-4 of the
    plain version, two launches bit-identical."""
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(13 * k)
    args = _odd_tail_args(gen, dev, gated, k)
    dy = torch.randn(*args[0].shape, generator=gen, device=dev)
    got = tail_bwd_kernel(*args[1:10], dy, k, True)
    again = tail_bwd_kernel(*args[1:10], dy, k, True)
    want = tail_bwd_plain(*args[:11], dy, k, True)
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        if w is None:
            assert a is None and b is None, i
            continue
        assert torch.equal(a, b), i
        assert _rel(a, w) <= 1e-4, (i, _rel(a, w))


def test_tail_backward_takes_float64s_branch_at_the_kink(dev):
    """t2 set so that slot 0 of point 0 sits on LeakyReLU's kink in every
    channel (v*s2 + t2 within rounding of 0): there the tensor cores' logit
    may fall on either side, and the kernel must take the branch of the
    float64 evaluation. Every slot-logit gradient rel <= 1e-4 of the
    plain backward evaluated in float64."""
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(23)
    k, two_fin = 10, 64
    args = list(_odd_tail_args(gen, dev, True, k, B=1, N=16,
                               four_fin=2 * two_fin, two_f=64))
    h, w2k, w2b, s2 = args[2], args[5], args[6], args[7]
    v0 = h[0, 0, :64].double() @ w2k.double() + w2b.double()
    args[8] = (-v0 * s2.double()).float()          # t2: upre(0, 0) ~ 0
    dy = torch.randn(*args[0].shape, generator=gen, device=dev)
    got = tail_bwd_kernel(*args[1:10], dy, k, True)
    want = tail_bwd_plain(*[a.double() if torch.is_tensor(a) else a
                            for a in args[:11]], dy.double(), k, True)
    for i in (2, 5, 6, 7, 8):                       # d_h, d_w2k..d_t2
        assert _rel(got[i], want[i]) <= 1e-4, (i, _rel(got[i], want[i]))


@pytest.mark.parametrize("gated,softmax,k,odd", [(True, True, 10, False),
                                                 (True, False, 10, False),
                                                 (True, True, 16, False),
                                                 (True, True, 18, False),
                                                 (True, True, 10, True),
                                                 (False, True, 10, True)])
def test_tail_backward_gate_is_the_forwards(dev, gated, softmax, k, odd):
    """The g that the backward's gate pass writes (for d_wi = g^T dy) is
    the forward gate's g bit for bit: the same tile, fragments, logits and
    softmax order, at k = 10, 16 and the wide gate's 18, with and without
    the softmax, at full-width-like and odd widths, and on the plain
    stage."""
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_kernel)

    gen = torch.Generator(device=dev).manual_seed(17 * k + odd)
    if odd:
        args = _odd_tail_args(gen, dev, gated, k)
    else:
        args = _odd_tail_args(gen, dev, gated, k, B=2, N=200, four_fin=256,
                              two_f=128)
    args[-1] = softmax
    dy = torch.randn(*args[0].shape, generator=gen, device=dev)
    _, g_fwd = tail_kernel(*args, keep_g=True)
    g_bwd = tail_bwd_kernel(*args[1:10], dy, k, softmax, keep_g=True)[-1]
    rows = args[1].shape[0] * args[1].shape[1]
    assert g_fwd.shape == g_bwd.shape == (rows, args[1].shape[-1])
    assert torch.equal(g_fwd, g_bwd)


@pytest.mark.parametrize("k,gated", [(14, True), (10, False)])
def test_head_backward_kernel_ragged_rows_and_odd_widths(dev, k, gated):
    """C = 30, 4Fin = 130 and 2F = 66 (no multiple of 4: the products'
    operands padded, the cotangents gathered in scalar columns), 135 rows,
    k = 14: every gradient rel <= 1e-4 of autograd's, two launches
    bit-identical."""
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(13 * k)
    B, N, C, four_fin, two_f = 3, 45, 30, 130, 66
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(B, N, C)
    x_knn, wn, ca, pb, am, wen, pbm, window = head_operands(
        x, r(1, window, 2 * C, four_fin) * 0.1, r(four_fin) * 0.1,
        r(2 * k * 2 * C, two_f) * 0.05, k)
    pcat = r(B, N, 32) if gated else None
    ppoint = r(B, N, 32) if gated else None
    idx, inte = edge_head(x, x_knn, wn, ca, pb, am, wen, pbm, pcat, ppoint,
                          k, window)[:2]
    cts = [r(*inte.shape), r(B, N, two_f), r(2, four_fin) * 0.01]
    if gated:
        cts += [r(B, N, k * 16), r(B, N, k * 16), r(2, k * 32) * 0.01]
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts, k)
    again = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                            k)
    want = head_bwd_plain(x, idx, wn, ca, pb, am, wen, pbm, pcat, ppoint,
                          cts, k, window)
    for i, (a, b, c) in enumerate(zip(got, want, again)):
        if b is None:
            assert a is None and c is None, i
        else:
            assert torch.equal(a, c), i
            assert _rel(a, b) <= 1e-4, (i, _rel(a, b))


def test_head_forward_keeps_its_bits(dev):
    assert head_bits(dev) == HEAD_BITS


@pytest.mark.parametrize("depth", [5120, 7168])
def test_product_core_folds_long_chains(dev, depth):
    """The shared product core alone at the gated tail merge's depth
    (5,120) and the head backward's Gc @ W_conv (7,168), 300 rows (ragged
    tiles), with an addend and a bias: folded, rel <= 1e-5 of float64, the
    limit of the CPU emulation (tests/test_torch_tf32x3.py)."""
    from pdgn_tpu_torch.ops.kernels.tc_gemm import tc_matmul

    g = torch.Generator(device=dev).manual_seed(depth)
    a = torch.randn(300, depth, generator=g, device=dev)
    b = torch.randn(depth, 68, generator=g, device=dev) * depth ** -0.5
    addend = torch.randn(300, 68, generator=g, device=dev)
    bias = torch.randn(68, generator=g, device=dev)
    got = tc_matmul(a, b, addend, bias)
    want = addend.double() + a.double() @ b.double() + bias.double()
    assert _rel(got, want) <= 1e-5


def test_product_core_transposed_splits(dev):
    """a^T b over 2 * 4096 + 100 rows (three splits, the last ragged): rel
    <= 1e-5 of float64, two launches bit-identical."""
    from pdgn_tpu_torch.ops.kernels.tc_gemm import tc_matmul

    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(2 * 4096 + 100, 132, generator=g, device=dev)
    b = torch.randn(2 * 4096 + 100, 72, generator=g, device=dev)
    got = tc_matmul(a, b, trans=True)
    assert torch.equal(got, tc_matmul(a, b, trans=True))
    assert _rel(got, a.double().T @ b.double()) <= 1e-5


def _local_residual_checks(src, centers, k, g_mu, g_cov, tol=1e-4):
    """The forward kernel's selection equal to the plain one, its residual
    equal to ``residual_plain``'s and rebuilding that set (k points a
    center), mu and cov rel <= tol; the backward kernel on that residual
    rel <= tol of ``bwd_mask_plain`` and of ``bwd_plain``."""
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel,
                                                        bwd_mask_plain,
                                                        bwd_plain,
                                                        fwd_kernel,
                                                        knn_direct,
                                                        residual_plain,
                                                        selection_mask,
                                                        stats_given_idx)

    idx, theta, tie, mu, cov = fwd_kernel(src, centers, k)
    assert torch.equal(idx, knn_direct(src, centers, k))
    theta_p, tie_p = residual_plain(src, centers, idx)
    assert torch.equal(theta, theta_p) and torch.equal(tie, tie_p)
    mask = selection_mask(src, centers, theta, tie)
    assert torch.equal(mask, torch.zeros_like(mask).scatter_(
        -1, idx.long(), True))
    mu_p, cov_p = stats_given_idx(src, idx.long())
    assert _rel(mu, mu_p) <= tol and _rel(cov, cov_p) <= tol
    d_src = bwd_kernel(src, centers, theta, tie, mu, g_mu, g_cov, k)
    assert _rel(d_src, bwd_mask_plain(src, centers, theta, tie, mu, g_mu,
                                      g_cov, k)) <= tol
    assert _rel(d_src, bwd_plain(src, idx, g_mu, g_cov)) <= tol
    return d_src


@pytest.mark.parametrize("B,M,N", [(2, 100, 300), (3, 128, 128)])
def test_local_stats_kernels_match_plain(dev, B, M, N):
    """Forward: the same neighbour sets as the plain version (exact fp32
    distances rounded alike), the residual (theta, tie) equal to the plain
    one and rebuilding those sets, mu and cov rel <= 1e-4; backward from
    the residual rel <= 1e-4 of both plain backwards, and a second launch
    bit-identical. The (3, 128, 128) case is self statistics on a cloud
    with duplicated points (ties, lowest index first)."""
    from pdgn_tpu_torch.ops.kernels.local_stats import bwd_kernel, fwd_kernel

    g = torch.Generator(device=dev).manual_seed(B * M + N)
    src = torch.randn(B, N, 3, generator=g, device=dev)
    if M == N:
        src[:, 1::2] = src[:, 0::2]          # every point twice
        centers = src
    else:
        centers = torch.randn(B, M, 3, generator=g, device=dev)
    g_mu = torch.randn(B, M, 3, generator=g, device=dev)
    g_cov = torch.randn(B, M, 9, generator=g, device=dev)
    d_src = _local_residual_checks(src, centers, 20, g_mu, g_cov)
    _, theta, tie, mu, _ = fwd_kernel(src, centers, 20)
    assert torch.equal(d_src, bwd_kernel(src, centers, theta, tie, mu, g_mu,
                                         g_cov, 20))


# the shape loss's local_mean_cov calls of one train step, (M centers, N
# points), as chip_smoke.py drives them
SHAPE_LOSS_CALLS = ((256, 256), (512, 512), (1024, 1024), (256, 512),
                    (256, 1024), (256, 2048), (512, 1024), (512, 2048),
                    (1024, 2048))


@pytest.mark.parametrize("M,N", SHAPE_LOSS_CALLS)
def test_local_stats_residual_at_the_shape_loss_calls(dev, M, N):
    """B=8 at each of the 9 shapes of a train step's shape loss, clouds
    refined from the coarser one (every point twice, jittered): the
    residual equal to ``residual_plain``'s and rebuilding the selection,
    the backward rel <= 1e-4 of ``bwd_mask_plain`` and ``bwd_plain``."""
    g = torch.Generator(device=dev).manual_seed(M + 3 * N)
    clouds = {256: torch.randn(8, 256, 3, generator=g, device=dev)}
    for n in (512, 1024, 2048):
        clouds[n] = (clouds[n // 2].repeat_interleave(2, dim=1) + 0.02
                     * torch.randn(8, n, 3, generator=g, device=dev))
    g_mu = torch.randn(8, M, 3, generator=g, device=dev)
    g_cov = torch.randn(8, M, 9, generator=g, device=dev)
    _local_residual_checks(clouds[N].contiguous(), clouds[M].contiguous(), 20,
                           g_mu, g_cov)


@pytest.mark.parametrize("B,M,N,k,ties", [(2, 100, 300, 7, False),
                                          (1, 512, 20000, 24, False),
                                          (1, 200, 700, 128, False),
                                          (2, 128, 128, 24, True),
                                          (1, 300, 19500, 20, False)])
def test_local_stats_wide_shapes_match_plain(dev, B, M, N, k, ties):
    """local_mean_cov at k other than the shape loss's 20 and at N up to
    20,000: the same neighbour sets as the plain version, mu and cov rel
    <= 1e-4, the backward rel <= 1e-4 given the same selection; both
    kernels launched once."""
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_plain,
                                                        knn_direct,
                                                        local_mean_cov,
                                                        stats_given_idx)

    g = torch.Generator(device=dev).manual_seed(M + N + k)
    src = torch.randn(B, N, 3, generator=g, device=dev)
    if ties:
        src[:, 1::2] = src[:, 0::2]
        centers = src
    else:
        centers = torch.randn(B, M, 3, generator=g, device=dev)
    s = src.clone().requires_grad_(True)
    _lib.LAUNCHES.clear()
    mu, cov = local_mean_cov(s, centers, k)
    idx = knn_direct(src, centers, k)
    mu_p, cov_p = stats_given_idx(src, idx)
    assert _rel(mu, mu_p) <= 1e-4 and _rel(cov, cov_p) <= 1e-4
    g_mu = torch.randn(B, M, 3, generator=g, device=dev)
    g_cov = torch.randn(B, M, 9, generator=g, device=dev)
    (d_src,) = torch.autograd.grad((mu, cov), (s,), (g_mu, g_cov))
    assert _rel(d_src, bwd_plain(src, idx, g_mu, g_cov)) <= 1e-4
    assert dict(_lib.LAUNCHES) == {"local_stats_fwd": 1,
                                   "local_stats_bwd": 1}


def test_local_stats_hub_rows_beyond_shared_memory(dev):
    """40,000 equal points: every center's 24 neighbours are points 0..23
    (ties, the lowest index first), so theta = 0 and tie = 23 at every
    center and only ``j <= tie`` decides the rebuilt selection; each of
    those rows is selected by all 40,000 centers (1.6e9 tests in one
    launch). The backward still matches the plain version."""
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel, bwd_plain,
                                                        fwd_kernel)

    N, k = 40_000, 24
    src = torch.full((1, N, 3), 0.25, device=dev)
    idx, theta, tie, mu, cov = fwd_kernel(src, src, k)
    assert torch.equal(idx[0].long(),
                       torch.arange(k, device=dev).expand(N, k))
    assert bool((theta == 0).all()) and bool((tie == k - 1).all())
    assert bool((mu == 0.25).all()) and bool((cov == 0).all())
    g = torch.Generator(device=dev).manual_seed(3)
    g_mu = torch.randn(1, N, 3, generator=g, device=dev)
    g_cov = torch.randn(1, N, 9, generator=g, device=dev)
    d_src = bwd_kernel(src, src, theta, tie, mu, g_mu, g_cov, k)
    assert bool((d_src[0, k:] == 0).all())
    assert _rel(d_src, bwd_plain(src, idx, g_mu, g_cov)) <= 1e-4


def test_head_backward_hub_rows_beyond_shared_memory(dev):
    """9,000 equal rows: every row's graph is the same 10 rows (ties, the
    lowest index first), so each of those is named by 9,000 rows, a
    reverse-adjacency list longer than the sort's shared memory (8,192
    entries, sorted in device memory instead); every gradient of the head
    backward still rel <= 1e-4 of autograd's."""
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(9)
    B, N, C, k = 1, 9000, 8, 10
    four_fin, two_f = 4 * C, 2 * C
    window = k // 2 + 1

    def r(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = r(1, 1, C).expand(B, N, C).contiguous()
    x_knn, wn, ca, pb, am, wen, pbm, window = head_operands(
        x, r(1, window, 2 * C, four_fin) * 0.1, r(four_fin) * 0.1,
        r(2 * k * 2 * C, two_f) * 0.05, k)
    idx, inte = edge_head(x, x_knn, wn, ca, pb, am, wen, pbm, None, None, k,
                          window)[:2]
    assert bool((idx == idx[:, :1]).all())   # one graph row for all rows
    cts = [r(*inte.shape), r(B, N, two_f), r(2, four_fin) * 0.01]
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, None, None, cts, k)
    want = head_bwd_plain(x, idx, wn, ca, pb, am, wen, pbm, None, None, cts,
                          k, window)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        else:
            assert _rel(a, b) <= 1e-4, (i, _rel(a, b))


def test_local_stats_kernel_refuses_what_it_cannot_take(dev):
    from pdgn_tpu_torch.ops.kernels.local_stats import local_mean_cov

    x = torch.zeros(1, 200, 3, device=dev)
    with pytest.raises(ValueError, match="MAX_K"):
        local_mean_cov(x, x, 129)
    big = torch.zeros(1, 0x10000 + 1, 3, device=dev)
    with pytest.raises(ValueError, match="MAX_POINTS"):
        local_mean_cov(big, big[:, :10], 8)


def test_generator_full_width_num_k_28_on_the_card(dev):
    """The full-width generator at num_k 28 (k = 14, no unrolled head
    instance) through the kernels: finite clouds, the launch counts of a
    forward, and each stage, fed on the card the inputs the plain CPU path
    gave it, rel <= 1e-3 at every point whose kNN row agrees (a differing
    row must be a near-tie)."""
    import copy

    from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist
    from pdgn_tpu_torch.train.generate import build_generator
    from pdgn_tpu_torch.train.sampler import frozen_running_stats

    model = build_generator(28, dev, num_k=28)
    # B=8 as chip_smoke.py's stage check: the global branch's batch norms
    # over fewer clouds amplify the CPU's and the card's rounding apart
    z = torch.randn(8, 128, generator=torch.Generator().manual_seed(28))
    _lib.LAUNCHES.clear()
    with torch.no_grad(), frozen_running_stats(model):
        clouds = model(z.to(dev))
    torch.cuda.synchronize()
    assert clouds[-1].shape == (8, 2048, 3)
    assert all(bool(torch.isfinite(c).all()) for c in clouds)
    assert dict(_lib.LAUNCHES) == {"edge_head": 4, "slot_stats": 3,
                                   "bilateral_tail_gated": 3,
                                   "bilateral_tail_plain": 1}

    cpu_model = copy.deepcopy(model).cpu()
    records = {}

    def hook(name):
        def fn(module, args, kwargs, output):
            records[name] = (args, kwargs, output)
        return fn

    handles = [getattr(cpu_model, f"bilateral{i}").register_forward_hook(
        hook(f"bilateral{i}"), with_kwargs=True) for i in range(1, 5)]
    with torch.no_grad(), frozen_running_stats(cpu_model):
        cpu_model(z)
    for h in handles:
        h.remove()

    def to_dev(v):
        return v.to(dev) if isinstance(v, torch.Tensor) else v

    with torch.no_grad(), frozen_running_stats(model):
        for name, (args, kwargs, want) in records.items():
            got = getattr(model, name)(*map(to_dev, args),
                                       **{k: to_dev(v)
                                          for k, v in kwargs.items()})
            idx_g, idx_w = got[3].cpu(), want[3]
            mism = idx_g != idx_w
            assert float(mism.float().mean()) <= 1e-3, name
            if bool(mism.any()):
                x = args[0]
                xs_in = kwargs.get("xs_in")
                if xs_in is not None:
                    x = torch.cat([xs_in[:, None, :].expand(
                        -1, x.shape[1], -1), x], dim=-1)
                d = self_pairwise_sqdist(x)
                dg, dw = d.gather(-1, idx_g.long()), d.gather(-1, idx_w.long())
                gap = (dg - dw).abs() / torch.maximum(
                    dg.abs(), dw.abs()).clamp_min(1e-12)
                assert float(gap[mism].max()) <= 1e-5, name
            keep = ~mism.any(-1)
            keep2 = torch.cat([keep, keep], dim=1)
            assert _rel(got[0].cpu(), want[0]) <= 1e-3, name
            assert _rel(got[2].cpu()[keep2], want[2][keep2]) <= 1e-3, name
            if want[1] is not None:
                assert _rel(got[1].cpu(), want[1]) <= 1e-3, name


def test_generator_backward_on_the_card_counts(dev):
    """A training forward and backward of the small generator on the card
    go through every forward and backward kernel once per stage."""
    from pdgn_tpu_torch.models.generator import PointGenerator
    from pdgn_tpu_torch.losses.shape_preserving import shape_preserving_terms

    model = PointGenerator(base_points=16).to(dev)
    _lib.LAUNCHES.clear()
    clouds = model(torch.randn(4, 128, device=dev))
    mu, cov = shape_preserving_terms(clouds)
    (sum(c.square().sum() for c in clouds) + mu + cov).backward()
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {
        "edge_head": 4, "slot_stats": 3, "bilateral_tail_gated": 3,
        "bilateral_tail_plain": 1, "edge_head_bwd": 4,
        "bilateral_tail_gated_bwd": 3, "bilateral_tail_plain_bwd": 1,
        "local_stats_fwd": 9, "local_stats_bwd": 9}
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


@pytest.mark.parametrize("n,S,R", [(100, 3, 2), (256, 2, 3), (1024, 2, 2),
                                   (3000, 1, 2), (8192, 1, 2)])
def test_emd_cd_kernel_matches_plain(dev, n, S, R):
    """Every pair of two sets: CD rel <= 1e-5 and cost rel <= 2e-3 of the
    plain version (chamfer_cd + match_cost; the kernel takes distances by
    direct differences, the plain path by the norm expansion, and at level
    -4^7 an ulp of d2 moves K by ~2e-3); a cloud against itself gives
    cd = 0; a second launch is bit-identical (fixed-order sums)."""
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd, emd_cd_plain

    g = torch.Generator(device=dev).manual_seed(n + S)
    a = torch.randn(S, n, 3, generator=g, device=dev) * 0.3
    b = torch.randn(R, n, 3, generator=g, device=dev) * 0.3
    b[0] = a[0]
    before = _lib.LAUNCHES["emd_cd"]
    cd, cost = emd_cd(a, b)
    assert _lib.LAUNCHES["emd_cd"] == before + 1
    cd_p, cost_p = emd_cd_plain(a, b)
    assert cd.shape == cost.shape == (S, R)
    assert float(cd[0, 0]) == 0.0 and float(cost[0, 0]) / n < 1e-3
    assert _rel(cd, cd_p) <= 1e-5
    assert _rel(cost, cost_p) <= 2e-3
    cd2, cost2 = emd_cd(a, b)
    assert torch.equal(cd, cd2) and torch.equal(cost, cost2)


def test_emd_cd_kernel_refuses_what_it_cannot_take(dev):
    """Unequal point counts and empty sets; there is no size limit."""
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd

    with pytest.raises(ValueError, match="n == m"):
        emd_cd(torch.zeros(1, 64, 3, device=dev),
               torch.zeros(1, 32, 3, device=dev))
    with pytest.raises(ValueError, match="empty"):
        emd_cd(torch.zeros(0, 64, 3, device=dev),
               torch.zeros(1, 64, 3, device=dev))


def test_emd_cd_culling_keeps_the_bits(dev):
    """Skipping the exact zeros of rounds 1-8 gives the same bits as
    visiting every element, and on clouds spread wider than a level's
    reach it does skip sub-tiles."""
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd_kernel

    g = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn(2, 2048, 3, generator=g, device=dev)
    b = torch.randn(3, 2048, 3, generator=g, device=dev)
    counts = torch.zeros(2, device=dev, dtype=torch.int64)
    cd, cost = emd_cd_kernel(a, b, counts=counts)
    cd0, cost0 = emd_cd_kernel(a, b, cull=False)
    assert torch.equal(cd, cd0) and torch.equal(cost, cost0)
    seen, culled = counts.tolist()
    assert 0 < culled < seen


def test_test_phase_on_the_card_counts(dev, tmp_path):
    """The small test phase on the card: one emd_cd launch a tile, finite
    metrics equal in kind to the CPU run's."""
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    cfg = ExperimentConfig(base_points=16, synthetic_size=6, batch_size=3,
                           device="cuda", save_dir=str(tmp_path))
    trainer = PDGNTrainer(cfg)
    trainer.build_model(seed=5)
    _lib.LAUNCHES.clear()
    res = trainer.test(tile=4)
    torch.cuda.synchronize()
    # 2x2 tiles against the other set, 2x2 for each set against itself
    assert _lib.LAUNCHES["emd_cd"] == 12
    assert _lib.LAUNCHES["edge_head"] == 8
    assert all(np.isfinite(v) for v in res.values())


def _duplicate_pairs(x):
    """Rows 2i and 2i + 1 equal (exact distance ties)."""
    n = x.shape[1] // 2 * 2
    x[:, 1:n:2] = x[:, 0:n:2]


def _near_tie_check(idx_k, idx_p, d, label):
    """kNN indices of a kernel against its plain version: equal but where
    a neighbour differs at a near-tie (its distance within 1e-5 relative of
    the one it replaces), at most 0.1% of the entries."""
    mism = idx_k != idx_p
    assert float(mism.float().mean()) <= 1e-3, label
    if bool(mism.any()):
        dk = d.gather(-1, idx_k.long())
        dp = d.gather(-1, idx_p.long())
        scale = torch.maximum(dk.abs(), dp.abs()).clamp_min(1e-12)
        assert float(((dk - dp).abs() / scale)[mism].max()) <= 1e-5, label


@pytest.mark.parametrize("B,M,N,C,k,ties", [
    (2, 100, 300, 3, 1, False), (3, 130, 257, 4, 3, True),
    (2, 77, 129, 5, 21, False), (2, 200, 333, 33, 100, False),
    (1, 128, 128, 3, 128, True), (2, 64, 200, 33, 128, False),
    (2, 150, 150, 33, 21, True)])
def test_knn_topk_kernel_matches_plain(dev, B, M, N, C, k, ties):
    """Ragged M and N, both distance branches, register (k <= 32) and
    shared-memory lists, duplicated points (ties: the lower index first).
    C <= 4 rounds as the plain version does, so the indices are equal; the
    norm expansion's dot products add in another order than cuBLAS, so
    there the near-tie rule holds. A second launch is bit-identical."""
    from pdgn_tpu_torch.ops.kernels.knn import (knn_topk, knn_topk_reference,
                                                sqdist)

    g = torch.Generator(device=dev).manual_seed(M + N + C + k)
    db = torch.randn(B, N, C, generator=g, device=dev)
    if ties:
        _duplicate_pairs(db)
    q = db[:, :M].clone() if ties else torch.randn(B, M, C, generator=g,
                                                    device=dev)
    before = _lib.LAUNCHES["knn_topk"]
    idx = knn_topk(q, db, k)
    assert _lib.LAUNCHES["knn_topk"] == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (B, M, k)
    want = knn_topk_reference(q, db, k)
    if C <= 4:
        assert torch.equal(idx, want)
    else:
        _near_tie_check(idx, want, sqdist(q, db), "knn_topk")
    assert torch.equal(idx, knn_topk(q, db, k))


@pytest.mark.parametrize("B,M,C,k,ties", [(2, 100, 3, 5, False),
                                          (2, 257, 33, 21, False),
                                          (3, 300, 128, 10, True),
                                          (1, 140, 4, 127, False),
                                          (2, 150, 5, 100, True)])
def test_knn_gather_kernel_matches_plain(dev, B, M, C, k, ties):
    """idx against the plain selection (near-tie rule for C > 4), nbr
    equal to grouping(x, idx) bit for bit, and the gradient of
    sum(nbr^2) rel <= 1e-5 of the plain version's for the same graph (both
    scatter-add with float atomics, in run-dependent orders)."""
    from pdgn_tpu_torch.ops.grouping import grouping
    from pdgn_tpu_torch.ops.kernels.knn import (knn_gather, knn_topk_reference,
                                                sqdist)

    g = torch.Generator(device=dev).manual_seed(M + C + k)
    x = torch.randn(B, M, C, generator=g, device=dev)
    if ties:
        _duplicate_pairs(x)
    x.requires_grad_(True)
    before = _lib.LAUNCHES["knn_gather"]
    idx, nbr = knn_gather(x, k)
    assert _lib.LAUNCHES["knn_gather"] == before + 1
    assert idx.shape == (B, M, k) and nbr.shape == (B, M, k, C)
    with torch.no_grad():
        want = knn_topk_reference(x, x, k + 1)[..., 1:]
        if C <= 4:
            assert torch.equal(idx, want)
        else:
            _near_tie_check(idx, want, sqdist(x, x), "knn_gather")
        assert torch.equal(nbr, grouping(x, idx))
    (grad,) = torch.autograd.grad((nbr ** 2).sum(), x)
    (grad_p,) = torch.autograd.grad((grouping(x, idx) ** 2).sum(), x)
    assert _rel(grad, grad_p) <= 1e-5


def test_point_ops_on_the_card_count_their_launches(dev):
    """The library's kNN users go through the kernels: knn and the
    grouping family through knn_topk, edge features and EdgeConv through
    knn_topk, neighbor_features through knn_gather; the EdgeConv backward
    launches nothing more."""
    from pdgn_tpu_torch import ops
    from pdgn_tpu_torch.models.generator import EdgeConv

    g = torch.Generator(device=dev).manual_seed(7)
    xyz = torch.randn(2, 300, 3, generator=g, device=dev)
    x = torch.randn(2, 200, 24, generator=g, device=dev)
    m = EdgeConv(24, 32, 6).to(dev)
    _lib.LAUNCHES.clear()
    ctr = ops.gather_points(xyz, ops.furthest_point_sample(xyz, 64))
    ops.group_xyz(xyz, ctr, nsample=8)
    ops.query_and_group(xyz, ctr, nsample=8)
    ops.query_and_group(xyz, ctr, nsample=8, radius=0.3)
    ops.edge_features(x, 6)
    ops.neighbor_features(x, 6)
    x.requires_grad_(True)
    m(x).sum().backward()
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"knn_topk": 4, "knn_gather": 1}
    assert torch.isfinite(x.grad).all()


def test_knn_kernels_refuse_what_they_cannot_take(dev):
    from pdgn_tpu_torch.ops.kernels.knn import knn_gather, knn_topk

    x = torch.zeros(1, 300, 3, device=dev)
    with pytest.raises(ValueError):
        knn_topk(x, x, 129)
    with pytest.raises(ValueError):
        knn_topk(x, x[:, :10], 11)
    with pytest.raises(ValueError):
        knn_gather(x, 128)
