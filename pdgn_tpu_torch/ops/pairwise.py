"""Batched pairwise squared distances (port of pdgn_tpu/ops/pairwise.py).

The ``|x|^2 - 2<x,y> + |y|^2`` expansion of the reference's
``get_edge_features`` (models/PDGNet_v2.py:449-454) and ``ChamferLoss``
(utils/chamfer_loss.py:23-39), in fp32 with the same rounding order as the
JAX package: ``(x2 - 2*xy) + y2``. Values can be slightly negative for
coincident points, as in the reference.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M, C) -> (B, N, M)`` squared distances."""
    xy = torch.matmul(x, y.transpose(-1, -2))
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    return x2 - 2.0 * xy + y2.transpose(-1, -2)


def self_pairwise_sqdist(x: torch.Tensor) -> torch.Tensor:
    """``(B, N, C) -> (B, N, N)`` squared distances of a cloud to itself."""
    xx = torch.matmul(x, x.transpose(-1, -2))
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x2 - 2.0 * xx + x2.transpose(-1, -2)
