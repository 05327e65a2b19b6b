"""Neighbourhood gathering (port of pdgn_tpu/ops/grouping.py::grouping)."""

from __future__ import annotations

import torch


def grouping(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``features (B, N, C)``, ``idx (B, M, K)`` -> ``(B, M, K, C)``."""
    B, N, C = features.shape
    _, M, K = idx.shape
    gid = idx.reshape(B, M * K).long() + (
        torch.arange(B, device=idx.device) * N)[:, None]
    out = features.reshape(B * N, C).index_select(0, gid.reshape(-1))
    return out.reshape(B, M, K, C)
