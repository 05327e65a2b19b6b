"""Radius (ball) neighbourhood query (port of pdgn_tpu/ops/ballquery.py).

For each center, the first ``nsample`` points (in point-index order) whose
squared distance is strictly below ``radius**2``; every remaining slot holds
the first hit, and a row without a hit stays 0 (the reference CUDA kernel,
ballquery_cuda_kernel.cu:6-44).
"""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def ballquery(radius: float, nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """``xyz (B, N, 3)``, ``new_xyz (B, M, 3)`` -> ``(B, M, nsample)``
    int32 indices, padded as the reference pads them."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    mask = pairwise_sqdist(new_xyz, xyz) < radius * radius      # (B, M, N)
    # rank of each hit among its row's hits (0-based, index order)
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    # point n goes to slot rank[n]; non-hits and overflow land in the
    # spare slot nsample, which is cut off
    slot = torch.where(mask & (rank < nsample), rank, nsample).long()
    point_idx = torch.arange(N, device=xyz.device).expand(B, M, N)
    out = torch.zeros(B, M, nsample + 1, dtype=torch.long, device=xyz.device)
    out.scatter_(-1, slot, point_idx)
    out = out[..., :nsample]
    cnt = mask.sum(dim=-1, keepdim=True)
    slots = torch.arange(nsample, device=xyz.device)
    return torch.where(slots < cnt, out, out[..., :1]).to(torch.int32)
