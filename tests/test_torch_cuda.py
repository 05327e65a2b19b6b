"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (edges that the full-width checks of
``chip_smoke.py`` never hit: row counts that fill no tile, channel counts
that are no multiple of a chunk, k other than 10).

Marked ``cuda``; each test skips unless a CUDA card is visible (decided in
the fixture, never at import). Run on a machine with a card with::

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from pdgn_tpu_torch.ops.edges import neighbor_idx
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import tail, tail_reference
from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                  head_operands,
                                                  head_reference_given_idx)
from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                   stats_plain)

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
                                            (64, 32, 32, 16, True)])
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
    idx_p = neighbor_idx(x_knn, k)
    assert float((got[0] != idx_p).float().mean()) <= 1e-3
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


@pytest.mark.parametrize("gated,softmax,k,fin", [(True, True, 10, 12),
                                                 (True, False, 6, 40),
                                                 (False, True, 10, 8)])
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
                                            (64, 32, 32, 16, True)])
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
                                                 (False, True, 10, 8)])
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


@pytest.mark.parametrize("B,M,N", [(2, 100, 300), (3, 128, 128)])
def test_local_stats_kernels_match_plain(dev, B, M, N):
    """Forward: the same neighbour sets as the plain version (exact fp32
    distances rounded alike), mu and cov rel <= 1e-4; backward rel <= 1e-4
    given the same selection. The (3, 128, 128) case is self statistics
    on a cloud with duplicated points (ties, lowest index first)."""
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel, bwd_plain,
                                                        fwd_kernel,
                                                        knn_direct,
                                                        stats_given_idx)

    g = torch.Generator(device=dev).manual_seed(B * M + N)
    src = torch.randn(B, N, 3, generator=g, device=dev)
    if M == N:
        src[:, 1::2] = src[:, 0::2]          # every point twice
        centers = src
    else:
        centers = torch.randn(B, M, 3, generator=g, device=dev)
    idx, mu, cov = fwd_kernel(src, centers, 20)
    want_idx = knn_direct(src, centers, 20)
    assert torch.equal(idx, want_idx)
    mu_p, cov_p = stats_given_idx(src, idx.long())
    assert _rel(mu, mu_p) <= 1e-4 and _rel(cov, cov_p) <= 1e-4
    g_mu = torch.randn(B, M, 3, generator=g, device=dev)
    g_cov = torch.randn(B, M, 9, generator=g, device=dev)
    assert _rel(bwd_kernel(src, idx, mu, g_mu, g_cov),
                bwd_plain(src, idx, g_mu, g_cov)) <= 1e-4


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
