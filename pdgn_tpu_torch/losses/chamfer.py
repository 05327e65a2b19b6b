"""Sum-reduced Chamfer distance (port of pdgn_tpu/losses/chamfer.py::
chamfer_loss, reference utils/chamfer_loss.py:7-39)."""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def chamfer_loss(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Squared distances to the nearest point in both directions, summed
    over batch and points: ``preds (B, Np, C)``, ``gts (B, Ng, C)``."""
    P = pairwise_sqdist(gts, preds)                       # (B, Ng, Np)
    return torch.sum(torch.amin(P, dim=1)) + torch.sum(torch.amin(P, dim=2))
