"""Bulk generation, the ``--phase sample`` serving path (port of
pdgn_tpu/train/trainer.py:348-423, ``PDGNTrainer.generate``).

``n`` finest-resolution clouds in batches of ``batch_size``, deterministic
from ``seed``: the weights come from ``pretrain_model_G`` when given, else
from a seeded torch default init; the noise from a ``torch.Generator`` on
the device seeded with ``seed``. The port's noise stream differs from the
JAX package's, so the same seed gives other clouds than ``pdgn_tpu``.
``dtype=torch.bfloat16`` builds the generator in the bf16 compute policy
(``--compute_dtype bfloat16``); the clouds are fp32 either way. With a
``mesh`` the ranks make whole batches in turn (``make_batched_sampler``),
every rank returns all the clouds, the one-process run's in order, and rank
0 alone writes them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.train.checkpoint import load_generator
from pdgn_tpu_torch.train.sampler import make_batched_sampler
from pdgn_tpu_torch.utils.misc import resolve_device


def build_generator(seed: int, device="cuda", num_point: int = 2048,
                    num_k: int = 20, base_points: int = 128,
                    pretrain_model_G: Optional[str] = None,
                    softmax: bool = True, noise_dim: int = 128,
                    dtype: Optional[torch.dtype] = None) -> PointGenerator:
    """A generator on ``device``: loaded from ``pretrain_model_G`` or drawn
    from a CPU ``torch.Generator`` seeded with ``seed`` (same weights on
    every device, whatever the compute ``dtype``)."""
    device = resolve_device(device)
    model = PointGenerator(num_point, num_k, softmax=softmax,
                           base_points=base_points, noise_dim=noise_dim,
                           dtype=dtype)
    if pretrain_model_G is not None:
        load_generator(pretrain_model_G, model)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def generate(n: int, batch_size: int = 50, seed: int = 9999, *,
             device: str = "cuda", model: Optional[PointGenerator] = None,
             out_path: Optional[str] = None, mesh=None,
             **model_kwargs) -> np.ndarray:
    """Generate ``n`` clouds ``(n, P, 3)``; saves them to ``out_path`` when
    given. ``model`` (already on ``device``, or on ``mesh.device``) skips
    building one; ``model_kwargs`` go to :func:`build_generator`."""
    dev = resolve_device(device if mesh is None else mesh.device)
    if model is None:
        model = build_generator(seed, dev, **model_kwargs)
    rng = torch.Generator(device=dev).manual_seed(seed)
    n_batches = -(-n // batch_size)
    clouds = make_batched_sampler(model, model.noise_dim, mesh)(
        n_batches, batch_size, rng)
    clouds = clouds.reshape(-1, *clouds.shape[2:])[:n].cpu().numpy()
    if out_path is not None and (mesh is None or mesh.rank == 0):
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, clouds)
    return clouds
