"""Approximate Earth Mover's Distance, the plain approxmatch (port of
pdgn_tpu/losses/emd.py, reference approxmatch.cu:3-224).

Nine temperature rounds (``level = -4^j``, j = 7..-1) of alternating row and
column mass balancing over the full ``n x m`` kernel matrix
``K = exp(level * D)``, ``D = max(pairwise_sqdist, 0)``. Each round's
transport ``ratioL K ratioR`` is folded into the cost at once, so the match
matrix is never stored. ``match_cost``'s backward recomputes the rounds with
the match held constant, as the reference's gradient kernels treat it
(match_cost.py:31-42). This is the plain version of the fused evaluation
kernel ``ops/kernels/emd_cd.py`` and the training-side loss; it materialises
several ``(B, n, m)`` fp32 matrices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist

# j = 7, 6, ..., -1 (the reference's level == 0 branch is unreachable)
_LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1))


def _multipliers(n: int, m: int) -> Tuple[float, float]:
    """Initial masses, with the reference's C integer division."""
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


def _rounds(xyz1: torch.Tensor, xyz2: torch.Tensor, with_grads: bool):
    """The nine balancing rounds: the cost ``(B,)`` and, with
    ``with_grads``, the gradients of the cost for a constant match."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multiL, multiR = _multipliers(n, m)

    D = torch.clamp_min(pairwise_sqdist(xyz1, xyz2), 0.0)  # (B, n, m)
    dist = torch.sqrt(D)
    # 1/dist clamped as the reference's gradient kernels do
    inv_dist = torch.rsqrt(torch.clamp_min(D, 1e-20)) if with_grads else None

    remainL = torch.full((B, n), multiL, dtype=D.dtype, device=D.device)
    remainR = torch.full((B, m), multiR, dtype=D.dtype, device=D.device)
    cost = torch.zeros(B, dtype=D.dtype, device=D.device)
    g1 = torch.zeros_like(xyz1) if with_grads else None
    g2 = torch.zeros_like(xyz2) if with_grads else None

    def mv(M, v):
        return torch.matmul(M, v[..., None])[..., 0]

    for level in _LEVELS:
        K = torch.exp(level * D)
        Kt = K.transpose(-1, -2)
        # pass 1: per-row share of the remaining left mass
        ratioL = remainL / (mv(K, remainR) + 1e-9)
        # pass 2: right absorption and the right remainder
        sumr = mv(Kt, ratioL) * remainR
        consumption = torch.clamp(remainR / (sumr + 1e-9), max=1.0)
        ratioR = consumption * remainR
        remainR = torch.clamp_min(remainR - sumr, 0.0)
        # pass 3: the transport increment K * ratioL x ratioR, folded
        remainL = torch.clamp_min(remainL - ratioL * mv(K, ratioR), 0.0)
        cost = cost + torch.sum(ratioL * mv(K * dist, ratioR), dim=-1)
        if with_grads:
            # grad1_k = x1_k * rowsum(W) - W @ x2, W = K ratioL ratioR / dist
            Winv = K * inv_dist
            Winv_t = Winv.transpose(-1, -2)
            row_w = ratioL * mv(Winv, ratioR)
            wx2 = ratioL[..., None] * torch.matmul(Winv,
                                                   ratioR[..., None] * xyz2)
            g1 = g1 + xyz1 * row_w[..., None] - wx2
            col_w = ratioR * mv(Winv_t, ratioL)
            wx1 = ratioR[..., None] * torch.matmul(Winv_t,
                                                   ratioL[..., None] * xyz1)
            g2 = g2 + xyz2 * col_w[..., None] - wx1
    return cost, g1, g2


class _MatchCost(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        ctx.save_for_backward(xyz1, xyz2)
        return _rounds(xyz1, xyz2, with_grads=False)[0]

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2 = ctx.saved_tensors
        _, g1, g2 = _rounds(xyz1, xyz2, with_grads=True)
        return g[:, None, None] * g1, g[:, None, None] * g2


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate-EMD transport cost ``sum(match * ||x1 - x2||)`` per pair:
    ``(B, n, 3), (B, m, 3) -> (B,)`` (reference ``match_cost``)."""
    return _MatchCost.apply(xyz1, xyz2)


def emd_approx(sample: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-pair EMD normalised by the point count (reference
    ``emd_approx``, evaluation_metrics.py:26-31), equal sizes only."""
    n, n_ref = sample.shape[1], ref.shape[1]
    if n != n_ref:
        raise ValueError(f"EMD requires equal point counts, got {n} vs "
                         f"{n_ref}")
    return match_cost(sample, ref) / float(n)
