"""Test-time samplers (port of pdgn_tpu/train/train_step.py:354-406).

z ~ N(0, 1) (test sigma; training noise is 0.2), drawn from an explicit
``torch.Generator`` on the model's device. The generator normalises with
the sampled batch's statistics (the reference never switches to eval), and
sampling leaves the running statistics unchanged, as the JAX sampler
discards its updated ``batch_stats``. The noise is fp32 whatever the
generator's compute dtype, and so are the clouds it returns.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Run ``model`` without moving its BN running averages (its batch
    norms still normalise with batch statistics), restoring its mode."""
    was_training = model.training
    model.train(False)
    try:
        yield model
    finally:
        model.train(was_training)


def make_sampler(generator: nn.Module, noise_dim: int = 128) -> Callable:
    """``sample(batch_size, rng, z=None)`` -> the four clouds. ``rng`` is a
    ``torch.Generator`` on the model's device; ``z`` overrides the noise
    (tests pass numpy noise in, as the two frameworks' streams differ)."""

    def sample(batch_size: int, rng: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None):
        dev = next(generator.parameters()).device
        if z is None:
            z = torch.randn(batch_size, noise_dim, generator=rng, device=dev)
        with torch.no_grad(), frozen_running_stats(generator):
            return generator(z)

    return sample


def make_batched_sampler(generator: nn.Module,
                         noise_dim: int = 128) -> Callable:
    """``sample_many(n_batches, batch_size, rng)`` -> the finest clouds of
    ``n_batches`` consecutive batches, ``(n_batches, batch_size, P, 3)``."""
    sample = make_sampler(generator, noise_dim)

    def sample_many(n_batches: int, batch_size: int,
                    rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.stack([sample(batch_size, rng)[3]
                            for _ in range(n_batches)])

    return sample_many
