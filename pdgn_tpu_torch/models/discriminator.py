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

``dtype=torch.bfloat16`` (``--d_compute_dtype bfloat16``) is the JAX
module's ``dtype``: the per-point conv stack computes in bf16 (operands,
products rounded, activations stored in bf16), while the BN statistics, the
pooled vector and the head stay fp32, with the JAX blocks' statistics
(``layers.dense_br``, ``layers.dense_br_pool``). The JAX trainer keeps its
discriminators in fp32 even under ``--compute_dtype bfloat16``: bf16
discriminators collapsed LSGAN training on the TPU
(pdgn_tpu/train/trainer.py:152-158).

``group`` (a ``torch.distributed`` process group) is the JAX module's
``axis_name``: each conv layer's batch norm then takes the global batch's
statistics over the ranks (both definitions of the bf16 stack's included),
``None`` each rank's own. A rank holds only real rows, so the JAX module's
padded-batch masks are not needed; its paired real|fake mode is not ported:
the train step runs D(real) and D(fake) as two calls, the same math.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pdgn_tpu_torch.models.layers import (MLP, BatchNorm, TorchDense,
                                          dense_br, dense_br_pool)
from pdgn_tpu_torch.parallel.sync_bn import set_group


class PointDiscriminator(nn.Module):
    """``(B, N, 3)`` clouds -> ``(B, 1)`` logits; ``group`` as the module
    docstring says."""

    def __init__(self, conv_features: Sequence[int],
                 head_features: Sequence[int], in_features: int = 3,
                 dtype: Optional[torch.dtype] = None, group=None):
        super().__init__()
        self.dtype = dtype
        layers = []
        fin = in_features
        for f in conv_features:
            layers += [TorchDense(fin, f, (1,), dtype),
                       BatchNorm(f, dtype=dtype), nn.LeakyReLU(0.01)]
            fin = f
        self.fc1 = nn.Sequential(*layers)
        self.mlp = MLP(fin, head_features, trailing=())
        self.axis = None
        set_group(self, group)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every parameter (torch default init) from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                batch: Optional[int] = None) -> torch.Tensor:
        """Under a group ``x`` holds this rank's rows of a ``batch``-row
        global batch."""
        if self.axis is not None:
            self.axis.begin(x.shape[0], batch)
        blocks = [(self.fc1[i], self.fc1[i + 1])
                  for i in range(0, len(self.fc1), 3)]
        for dense, bn in blocks[:-1]:
            x = dense_br(dense, bn, x)
        return self.mlp(dense_br_pool(*blocks[-1], x))


def PointDiscriminator1(dtype=None, group=None) -> PointDiscriminator:
    """256-point discriminator."""
    return PointDiscriminator((64, 128, 256), (128, 64, 1), dtype=dtype,
                              group=group)


def PointDiscriminator2(dtype=None, group=None) -> PointDiscriminator:
    """512-point discriminator."""
    return PointDiscriminator((64, 128, 256, 512), (256, 64, 1), dtype=dtype,
                              group=group)


def PointDiscriminator3(dtype=None, group=None) -> PointDiscriminator:
    """1024-point discriminator."""
    return PointDiscriminator((64, 128, 256, 512), (256, 64, 1), dtype=dtype,
                              group=group)


def PointDiscriminator4(dtype=None, group=None) -> PointDiscriminator:
    """2048-point discriminator."""
    return PointDiscriminator((64, 128, 256, 1024), (512, 256, 64, 1),
                              dtype=dtype, group=group)


def discriminators(dtype=None):
    """The four discriminators, coarsest first; ``dtype`` None (fp32) or
    ``torch.bfloat16`` for their conv stacks."""
    return (PointDiscriminator1(dtype), PointDiscriminator2(dtype),
            PointDiscriminator3(dtype), PointDiscriminator4(dtype))
