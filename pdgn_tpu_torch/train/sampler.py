"""Test-time samplers (port of pdgn_tpu/train/train_step.py:354-406).

z ~ N(0, 1) (test sigma; training noise is 0.2), drawn from an explicit
``torch.Generator`` on the model's device. The generator normalises with
the sampled batch's statistics (the reference never switches to eval), and
sampling leaves the running statistics unchanged, as the JAX sampler
discards its updated ``batch_stats``. The noise is fp32 whatever the
generator's compute dtype, and so are the clouds it returns.

Since each batch normalises over itself, the JAX package's batch sharded
over a mesh with global statistics is the same math as whole batches
handed out to ranks in turn: with a ``mesh`` rank r generates batches r,
r + W, ... with each rank's own statistics (no collective in the forward),
every rank draws every batch's noise from the same generator in order, and
one sum over the ranks gathers the clouds, batch by batch in order, as one
process makes them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn

from pdgn_tpu_torch.parallel.sync_bn import replica_local


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Run ``model`` without moving its BN running averages (its batch
    norms still normalise with batch statistics), restoring its mode."""
    was_training = model.training
    model.train(False)
    try:
        with replica_local(model):
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


def make_batched_sampler(generator: nn.Module, noise_dim: int = 128,
                         mesh=None) -> Callable:
    """``sample_many(n_batches, batch_size, rng)`` -> the finest clouds of
    ``n_batches`` consecutive batches, ``(n_batches, batch_size, P, 3)``;
    with a ``mesh`` on every rank, each batch made by one rank (see the
    module docstring)."""
    sample = make_sampler(generator, noise_dim)

    def sample_many(n_batches: int, batch_size: int,
                    rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if mesh is None:
            return torch.stack([sample(batch_size, rng)[3]
                                for _ in range(n_batches)])
        dev = next(generator.parameters()).device
        out = torch.zeros(n_batches, batch_size,
                          16 * generator.base_points, 3, device=dev)
        for i in range(n_batches):
            z = torch.randn(batch_size, noise_dim, generator=rng, device=dev)
            if i % mesh.world == mesh.rank:
                out[i] = sample(batch_size, z=z)[3]
        return mesh.sum_(out)

    return sample_many
