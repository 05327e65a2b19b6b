"""PointNet-style per-resolution discriminators (port of
pdgn_tpu/models/discriminator.py; reference ``PointDiscriminator_{1..4}``,
models/PDGNet_v2.py:882-1023).

A shared 1x1-conv stack (``fc1``: Conv1d, BN, LeakyReLU per layer), a max
over the points after the last layer, and a Linear head (``mlp``) to one
logit. Module names and layouts are the reference's, so a reference
``D_model{i}`` loads with ``load_state_dict`` (``module.`` prefix stripped):

  D1: 3-64-128-256        head 256-128-64-1
  D2: 3-64-128-256-512    head 512-256-64-1
  D3: 3-64-128-256-512    head 512-256-64-1
  D4: 3-64-128-256-1024   head 1024-512-256-64-1

Padded-batch masks and the paired real|fake mode of the JAX module are not
ported: the train step runs D(real) and D(fake) as two calls, the same math.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pdgn_tpu_torch.models.layers import (MLP, BatchNorm, TorchDense,
                                          dense_br, dense_br_pool)


class PointDiscriminator(nn.Module):
    """``(B, N, 3)`` clouds -> ``(B, 1)`` logits."""

    def __init__(self, conv_features: Sequence[int],
                 head_features: Sequence[int], in_features: int = 3):
        super().__init__()
        layers = []
        fin = in_features
        for f in conv_features:
            layers += [TorchDense(fin, f, (1,)), BatchNorm(f),
                       nn.LeakyReLU(0.01)]
            fin = f
        self.fc1 = nn.Sequential(*layers)
        self.mlp = MLP(fin, head_features, trailing=())

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every parameter (torch default init) from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = [(self.fc1[i], self.fc1[i + 1])
                  for i in range(0, len(self.fc1), 3)]
        for dense, bn in blocks[:-1]:
            x = dense_br(dense, bn, x)
        return self.mlp(dense_br_pool(*blocks[-1], x))


def PointDiscriminator1() -> PointDiscriminator:
    """256-point discriminator."""
    return PointDiscriminator((64, 128, 256), (128, 64, 1))


def PointDiscriminator2() -> PointDiscriminator:
    """512-point discriminator."""
    return PointDiscriminator((64, 128, 256, 512), (256, 64, 1))


def PointDiscriminator3() -> PointDiscriminator:
    """1024-point discriminator."""
    return PointDiscriminator((64, 128, 256, 512), (256, 64, 1))


def PointDiscriminator4() -> PointDiscriminator:
    """2048-point discriminator."""
    return PointDiscriminator((64, 128, 256, 1024), (512, 256, 64, 1))


def discriminators():
    """The four discriminators, coarsest first."""
    return (PointDiscriminator1(), PointDiscriminator2(),
            PointDiscriminator3(), PointDiscriminator4())
