"""Three-nearest-neighbour search and weighted interpolation (port of
pdgn_tpu/ops/interpolation.py; reference interpolation_cuda_kernel.cu)."""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.ops.knn import topk_ascending_idx
from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def three_nn(unknown: torch.Tensor,
             known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``unknown (B, N, 3)``, ``known (B, M, 3)`` -> euclidean ``dist
    (B, N, 3)`` ascending and ``idx (B, N, 3)`` int32, the lowest index
    first on ties (``lax.top_k``'s order in JAX; ``torch.topk`` promises no
    order among ties, so the selection is ``topk_ascending_idx``'s argmin
    passes). Squared distances below 0 (the norm expansion) clamp to 0."""
    d2 = pairwise_sqdist(unknown, known)
    idx = topk_ascending_idx(d2, 3)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, -1, idx.long()), 0.0))
    return dist, idx


def interpolate(features: torch.Tensor, idx: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """``features (B, M, C)``, ``idx``/``weight (B, N, 3)`` -> ``(B, N, C)``,
    the weighted sum of the three neighbours' features in slot order."""
    B, M, C = features.shape
    N = idx.shape[1]
    g = torch.gather(features, 1, idx.reshape(B, N * 3).long()[..., None]
                     .expand(-1, -1, C)).reshape(B, N, 3, C)
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) \
        + g[:, :, 2] * w[:, :, 2]


def three_interpolate_weights(dist: torch.Tensor,
                              eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights ``(B, N, 3)`` normalised to sum to 1."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
