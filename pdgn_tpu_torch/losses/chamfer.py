"""Chamfer distances (port of pdgn_tpu/losses/chamfer.py): the sum-reduced
training loss (reference utils/chamfer_loss.py:7-39) and the evaluation
suite's per-point minima and per-pair scalar (reference
evaluation/evaluation_metrics.py:35-45, :66/:108)."""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def chamfer_loss(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Squared distances to the nearest point in both directions, summed
    over batch and points: ``preds (B, Np, C)``, ``gts (B, Ng, C)``."""
    P = pairwise_sqdist(gts, preds)                       # (B, Ng, Np)
    return torch.sum(torch.amin(P, dim=1)) + torch.sum(torch.amin(P, dim=2))


def dist_chamfer(a: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point squared-distance minima in both directions: for each b
    point the min over a ``(B, N_b)``, for each a point the min over b
    ``(B, N_a)`` (reference ``distChamfer``)."""
    P = pairwise_sqdist(a, b)                             # (B, N_a, N_b)
    return torch.amin(P, dim=1), torch.amin(P, dim=2)


def chamfer_cd(sample: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The evaluation suite's CD per pair, ``dl.mean + dr.mean``:
    ``(B, N, 3), (B, N, 3) -> (B,)``."""
    dl, dr = dist_chamfer(sample, ref)
    return torch.mean(dl, dim=1) + torch.mean(dr, dim=1)
