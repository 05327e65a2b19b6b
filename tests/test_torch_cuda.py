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
