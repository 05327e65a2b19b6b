"""The GAN train step: 4 discriminator updates + 1 generator update (port of
pdgn_tpu/train/train_step.py:40-351; reference models/PDGNet_v2.py:157-256).

Semantics kept from the JAX step:

* the fakes for the D updates come from noise ``noise_d`` and are detached;
* D_i sees the real and the fake cloud in two calls (two BN batches, real
  first), loss ``(MSE(D(real), 1) + MSE(D(fake), 0)) / 2``;
* the G update generates again from fresh noise ``noise_g`` and flows through
  the discriminators *after* their update (their BN running statistics move
  in this forward too); its loss is
  ``sum_i adv_w[i] * MSE(D_i(fake_i), 1) + similar_w * (mu_w*mu + cov_w*cov)``;
* both generator forwards update its BN running statistics;
* Adam(lr, betas (0.5, 0.999)) per network, per tensor (the JAX package's
  flat-bundle Adam is a TPU layout experiment and is not ported).

The noise is an argument, already scaled by ``noise_sigma``: the trainer
draws it from a ``torch.Generator``; a test hands in the JAX step's noise.

Data parallelism (a :class:`~pdgn_tpu_torch.parallel.mesh.Mesh` in the
state, the JAX step jitted over a sharded batch): each rank holds its rows
of the real clouds and keeps its rows of the global noise; every batch norm
takes the global batch's statistics, every batch mean is this rank's sum
over the global count, each model's gradients are summed over the ranks in
one coalesced ``all_reduce`` before its update, and the metrics returned are
the global batch's. Parameters and Adam states stay equal on every rank
because every rank applies the same summed gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pdgn_tpu_torch.losses.gan import d_loss, g_adv_loss
from pdgn_tpu_torch.losses.shape_preserving import shape_preserving_loss
from pdgn_tpu_torch.parallel.mesh import Mesh, replicate
from pdgn_tpu_torch.parallel.sync_bn import set_group


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Loss weights and hyperparameters (v2 defaults, reference
    models/PDGNet_v2.py:250-253; :meth:`v1` gives models/PDGNet.py:262-265).
    """

    learning_rate: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.999
    noise_dim: int = 128
    noise_sigma: float = 0.2
    adv_weights: Tuple[float, float, float, float] = (1.2, 1.2, 1.2, 1.0)
    mu_weight: float = 1.0
    cov_weight: float = 1.0
    similar_weight: float = 0.1
    shape_nsample: int = 20

    @classmethod
    def v1(cls, **kw) -> "TrainConfig":
        kw.setdefault("cov_weight", 5.0)
        kw.setdefault("similar_weight", 0.5)
        return cls(**kw)


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam(lr, betas=(beta1, beta2)), reference models/PDGNet_v2.py:121-125."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2))


@dataclasses.dataclass
class GANState:
    """Generator, the four discriminators, their optimizers, step count,
    and the data axis of a multi-process run (``None``: one process)."""

    generator: nn.Module
    discriminators: Tuple[nn.Module, ...]
    g_opt: torch.optim.Optimizer
    d_opts: Tuple[torch.optim.Optimizer, ...]
    step: int = 0
    mesh: Optional[Mesh] = None


def init_state(generator: nn.Module, discriminators: Sequence[nn.Module],
               cfg: TrainConfig, mesh: Optional[Mesh] = None) -> GANState:
    """Wrap models (already on their device) with fresh optimizers. With a
    ``mesh`` every model takes global batch statistics over its group and
    its parameters and buffers are broadcast from rank 0."""
    if mesh is not None:
        for m in (generator,) + tuple(discriminators):
            set_group(m, mesh.group)
        replicate(mesh, generator, *discriminators)
    return GANState(generator, tuple(discriminators),
                    make_optimizer(generator, cfg),
                    tuple(make_optimizer(d, cfg) for d in discriminators),
                    mesh=mesh)


METRICS = ("d_loss1", "d_loss2", "d_loss3", "d_loss4", "g_loss",
           "similar_loss")


def train_step(state: GANState, reals: Sequence[torch.Tensor],
               noise_d: torch.Tensor, noise_g: torch.Tensor,
               cfg: TrainConfig = TrainConfig()) -> Dict[str, torch.Tensor]:
    """One GAN step in place on ``state``. ``reals``: the four real clouds
    ``(B, {256,512,1024,2048}, 3)``; ``noise_d``/``noise_g``: ``(B,
    noise_dim)``. Returns the six metrics as 0-d tensors on the device.
    With ``state.mesh``, ``reals`` hold this rank's rows
    (``mesh.rows(B)``) and the noise is the global batch's."""
    G, Ds, mesh = state.generator, state.discriminators, state.mesh
    G.train()
    for D in Ds:
        D.train()
    batch = None
    if mesh is not None:
        batch = noise_d.shape[0]
        rows = mesh.rows(batch)
        noise_d, noise_g = noise_d[rows], noise_g[rows]
        if any(r.shape[0] != noise_d.shape[0] for r in reals):
            raise ValueError(f"reals hold {[r.shape[0] for r in reals]} "
                             f"rows; rank {mesh.rank} of a {batch}-row "
                             f"batch holds {noise_d.shape[0]}")

    with torch.no_grad():
        fakes = G(noise_d, batch=batch)
    d_losses = []
    for D, opt, real, fake in zip(Ds, state.d_opts, reals, fakes):
        opt.zero_grad(set_to_none=True)
        loss = d_loss(D(real, batch=batch), D(fake, batch=batch), batch)
        loss.backward()
        if mesh is not None:
            mesh.sum_grads(D)
        opt.step()
        d_losses.append(loss.detach())

    state.g_opt.zero_grad(set_to_none=True)
    fakes = G(noise_g, batch=batch)
    similar = shape_preserving_loss(fakes, cfg.shape_nsample, cfg.mu_weight,
                                    cfg.cov_weight)
    adv = 0.0
    for w, D, fake in zip(cfg.adv_weights, Ds, fakes):
        adv = adv + w * g_adv_loss(D(fake, batch=batch), batch)
    g_loss = adv + cfg.similar_weight * similar
    # only G's parameters take this gradient (D's grads are not touched)
    g_loss.backward(inputs=list(G.parameters()))
    if mesh is not None:
        mesh.sum_grads(G)
    state.g_opt.step()
    state.step += 1
    metrics = d_losses + [g_loss.detach(), similar.detach()]
    if mesh is not None:
        metrics = mesh.sum_(torch.stack(metrics)).unbind()
    return dict(zip(METRICS, metrics))
