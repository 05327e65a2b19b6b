"""Nearest-centroid feature distribution (port of
pdgn_tpu/ops/featuredistribute.py; reference
featuredistribute_cuda_kernel.cu)."""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def feature_distribute(max_xyz: torch.Tensor,
                       xyz: torch.Tensor) -> torch.Tensor:
    """``(B, M)`` int32: the nearest ``max_xyz (B, N, 3)`` point of every
    ``xyz (B, M, 3)`` point, the lowest index first on ties."""
    return torch.argmin(pairwise_sqdist(xyz, max_xyz), dim=-1).to(torch.int32)


def feature_gather(max_feature: torch.Tensor,
                   distribute_idx: torch.Tensor) -> torch.Tensor:
    """``max_feature (B, N, C)``, ``distribute_idx (B, M)`` -> ``(B, M, C)``
    (autograd gives the scatter-add backward)."""
    C = max_feature.shape[-1]
    return torch.gather(max_feature, 1,
                        distribute_idx.long()[..., None].expand(-1, -1, C))
