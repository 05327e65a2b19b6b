"""Generator checkpoints in the reference's ``.pth`` format (port of the G
side of pdgn_tpu/train/checkpoint.py).

The reference saves ``{"G_model", "G_optimizer", "G_epoch"}`` with
``torch.save`` (models/PDGNet_v2.py:384-408), often from an
``nn.DataParallel`` wrapper whose keys carry a ``module.`` prefix. The
port's module names are the reference's, so loading is ``load_state_dict``.
Reading and writing the JAX package's msgpack bundles is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn


def strip_module(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the ``module.`` prefix of DataParallel state dicts."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_generator(path: str, model: nn.Module) -> int:
    """Load a reference-format G checkpoint (or a bare state dict) into
    ``model``; returns ``G_epoch`` (0 when absent). The file is read with
    ``weights_only=True``: tensors, containers and numbers load (the
    reference's bundle holds nothing else), any other pickled object is
    refused."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found at {path}")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw["G_model"] if "G_model" in raw else raw
    model.load_state_dict(strip_module(sd))
    return int(raw.get("G_epoch", 0))
