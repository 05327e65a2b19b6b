"""Checkpoints in the reference's two-bundle ``.pth`` format (port of
pdgn_tpu/train/checkpoint.py, reference models/PDGNet_v2.py:384-408).

Per snapshot ``<epoch>_<category>_G.pth`` holds ``{"G_model", "G_optimizer",
"G_epoch"}`` and ``<epoch>_<category>_D.pth`` ``{"D_model1".."D_model4",
"D_optimizer1".."D_optimizer4", "D_epoch"}``, written with ``torch.save``.
Reference bundles often come from an ``nn.DataParallel`` wrapper whose keys
carry a ``module.`` prefix. The port's module names are the reference's, so
loading is ``load_state_dict``. Files are read with ``weights_only=True``:
tensors, containers and numbers load (the bundles hold nothing else), any
other pickled object is refused. Reading and writing the JAX package's
msgpack bundles is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
from torch import nn


def strip_module(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the ``module.`` prefix of DataParallel state dicts."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _read(path: str) -> Dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_generator(path: str, model: nn.Module) -> int:
    """Load a reference-format G checkpoint (or a bare state dict) into
    ``model``; returns ``G_epoch`` (0 when absent)."""
    raw = _read(path)
    sd = raw["G_model"] if "G_model" in raw else raw
    model.load_state_dict(strip_module(sd))
    return int(raw.get("G_epoch", 0))


def save(checkpoint_dir: str, state, epoch: int,
         category: str) -> Tuple[str, str]:
    """Write the G and D bundles of a ``GANState``; returns their paths."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    name = os.path.join(checkpoint_dir, f"{epoch}_{category}")
    torch.save({"G_model": state.generator.state_dict(),
                "G_optimizer": state.g_opt.state_dict(),
                "G_epoch": epoch}, name + "_G.pth")
    bundle = {"D_epoch": epoch}
    for i, (d, opt) in enumerate(zip(state.discriminators, state.d_opts), 1):
        bundle[f"D_model{i}"] = d.state_dict()
        bundle[f"D_optimizer{i}"] = opt.state_dict()
    torch.save(bundle, name + "_D.pth")
    return name + "_G.pth", name + "_D.pth"


def load(path_g: str, path_d: str, state) -> int:
    """Restore both bundles into a ``GANState`` (models and optimizers);
    both files are required, as in the reference loader
    (models/PDGNet_v2.py:333-382). Returns ``G_epoch``."""
    raw_g, raw_d = _read(path_g), _read(path_d)
    state.generator.load_state_dict(strip_module(raw_g["G_model"]))
    state.g_opt.load_state_dict(raw_g["G_optimizer"])
    for i, (d, opt) in enumerate(zip(state.discriminators, state.d_opts), 1):
        d.load_state_dict(strip_module(raw_d[f"D_model{i}"]))
        opt.load_state_dict(raw_d[f"D_optimizer{i}"])
    return int(raw_g["G_epoch"])
