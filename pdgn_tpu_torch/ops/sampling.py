"""Furthest point sampling and index gather (port of
pdgn_tpu/ops/sampling.py; reference sampling_cuda_kernel.cu)."""

from __future__ import annotations

import torch


def furthest_point_sample(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, N, C) -> (B, m)`` int32 indices by iterative farthest-point
    sampling: the first is index 0, each next one maximises the running
    minimum squared distance to the chosen set (initialised to 1e10; ties
    go to the lowest index, ``argmax``'s first maximum). The squared
    distance sums the channels in order from 0, as the JAX package's
    reduction does."""
    B, N, C = xyz.shape
    idxs = torch.zeros(B, m, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0, :]
    mind2 = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    for i in range(1, m):
        diff = xyz - last[:, None, :]
        sq = diff * diff
        d2 = sq[..., 0]
        for c in range(1, C):
            d2 = d2 + sq[..., c]
        mind2 = torch.minimum(mind2, d2)
        nxt = torch.argmax(mind2, dim=-1)
        idxs[:, i] = nxt.to(torch.int32)
        last = xyz[rows, nxt]
    return idxs


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``features (B, N, C)``, ``idx (B, M)`` -> ``(B, M, C)`` (reference
    ``pointops.gathering``; autograd gives the scatter-add backward)."""
    C = features.shape[-1]
    return torch.gather(features, 1,
                        idx.long()[..., None].expand(-1, -1, C))
