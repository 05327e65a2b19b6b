"""LSGAN objectives (port of pdgn_tpu/losses/gan.py, unmasked): torch
``nn.MSELoss`` against constant 1/0 targets, mean reduction (reference
models/PDGNet_v2.py:116,187-253)."""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error, mean over every element."""
    return torch.mean(torch.square(pred - target))


def d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    """Discriminator loss ``(MSE(real, 1) + MSE(fake, 0)) / 2``."""
    return (mse_loss(pred_real, torch.ones_like(pred_real))
            + mse_loss(pred_fake, torch.zeros_like(pred_fake))) / 2.0


def g_adv_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    """Generator loss ``MSE(fake, 1)``."""
    return mse_loss(pred_fake, torch.ones_like(pred_fake))
