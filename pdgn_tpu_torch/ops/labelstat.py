"""Per-class label statistics over local neighbourhoods (port of
pdgn_tpu/ops/labelstat.py; reference labelstat_cuda_kernel.cu).

The counts are sums of integers; they are taken as float64 products, exact
below 2^53, because the card has no integer matrix product.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.ops.ballquery import ballquery
from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def _count(mask: torch.Tensor, label_stat: torch.Tensor) -> torch.Tensor:
    return torch.matmul(mask.double(), label_stat.double()).to(torch.int32)


def labelstat_ballrange(radius: float, xyz: torch.Tensor,
                        new_xyz: torch.Tensor,
                        label_stat: torch.Tensor) -> torch.Tensor:
    """Per-class counts ``(B, M, nclass)`` int32 over every point of
    ``xyz (B, N, 3)`` within ``radius`` of each center; ``label_stat
    (B, N, nclass)``."""
    return _count(pairwise_sqdist(new_xyz, xyz) < radius * radius,
                  label_stat)


def labelstat_idx(label_stat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-class counts ``(B, M, nclass)`` int32 over the neighbour sets
    ``idx (B, M, nsample)``."""
    B, N, nclass = label_stat.shape
    _, M, K = idx.shape
    g = torch.gather(label_stat, 1, idx.reshape(B, M * K).long()[..., None]
                     .expand(-1, -1, nclass))
    return g.reshape(B, M, K, nclass).sum(dim=2).to(torch.int32)


def labelstat_and_ballquery(radius: float, nsample: int, xyz: torch.Tensor,
                            new_xyz: torch.Tensor, label_stat: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ballquery` plus the counts over the first ``nsample`` hits
    only (the CUDA kernel stops its scan there)."""
    idx = ballquery(radius, nsample, xyz, new_xyz)
    mask = pairwise_sqdist(new_xyz, xyz) < radius * radius
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    return idx, _count(mask & (rank < nsample), label_stat)
