"""LSGAN objectives (port of pdgn_tpu/losses/gan.py, unmasked): torch
``nn.MSELoss`` against constant 1/0 targets, mean reduction (reference
models/PDGNet_v2.py:116,187-253).

``count`` serves data-parallel steps: ``pred`` holds this rank's rows of a
``count``-row global batch, and the loss is this rank's share of the global
mean (its sum over the global element count), so the ranks' losses and
their gradients add up to the global batch's.
"""

from __future__ import annotations

from typing import Optional

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             count: Optional[int] = None) -> torch.Tensor:
    """Mean squared error, mean over every element (of the global batch
    when ``count`` is given)."""
    sq = torch.square(pred - target)
    if count is None:
        return torch.mean(sq)
    return torch.sum(sq) / (sq.numel() // sq.shape[0] * count)


def d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor,
           count: Optional[int] = None) -> torch.Tensor:
    """Discriminator loss ``(MSE(real, 1) + MSE(fake, 0)) / 2``."""
    return (mse_loss(pred_real, torch.ones_like(pred_real), count)
            + mse_loss(pred_fake, torch.zeros_like(pred_fake), count)) / 2.0


def g_adv_loss(pred_fake: torch.Tensor,
               count: Optional[int] = None) -> torch.Tensor:
    """Generator loss ``MSE(fake, 1)``."""
    return mse_loss(pred_fake, torch.ones_like(pred_fake), count)
