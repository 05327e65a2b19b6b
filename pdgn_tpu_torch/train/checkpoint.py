"""Two-bundle G/D checkpoints in two formats (port of
pdgn_tpu/train/checkpoint.py, reference models/PDGNet_v2.py:384-408).

Per snapshot a ``<epoch>_<category>_G`` bundle ``{"G_model", "G_optimizer",
"G_epoch"}`` and a ``<epoch>_<category>_D`` bundle ``{"D_model1"..
"D_model4", "D_optimizer1".."D_optimizer4", "D_epoch"}``:

* ``.pth`` (the trainer's default, the reference's format): ``torch.save``
  of ``state_dict``s. Reference bundles often come from an
  ``nn.DataParallel`` wrapper whose keys carry a ``module.`` prefix; the
  port's module names are the reference's, so loading is
  ``load_state_dict``. Files are read with ``weights_only=True``: tensors,
  containers and numbers load, any other pickled object is refused.
* ``.msgpack`` (the JAX package's format, ``save(..., fmt="msgpack")``):
  flax msgpack written and read by ``utils.msgpack``. Each model entry is
  ``{"params", "batch_stats"}`` in flax layout and each optimizer entry
  optax ``adam``'s state (``convert_ckpt``'s table, both ways), so
  ``pdgn_tpu.train.checkpoint.load`` restores a bundle the port wrote and
  the port resumes from one the JAX package wrote. The BN layers'
  ``num_batches_tracked`` counters, which flax has no place for, ride in
  ``G_torch_counters``/``D_torch_counters<i>`` (ignored by the JAX loader;
  0 when a bundle lacks them).

:func:`load` reads each file by its extension.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from pdgn_tpu_torch.convert_ckpt import (COUNTER, adam_from_jax, adam_to_jax,
                                         discriminator_rules_of,
                                         discriminator_state_from_jax,
                                         discriminator_state_to_jax,
                                         generator_rules,
                                         generator_state_from_jax,
                                         generator_state_to_jax,
                                         strip_module)
from pdgn_tpu_torch.utils import msgpack

FORMATS = ("pth", "msgpack")


# ------------------------------------------------------------ msgpack trees
def to_state_dict(tree):
    """flax's ``to_state_dict`` for plain trees: lists and tuples become
    dicts keyed ``"0"``, ``"1"``, ...; leaves stay."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_state(path: str, tree) -> None:
    """Serialise a tree of dicts, lists and arrays to one msgpack file."""
    with open(path, "wb") as f:
        f.write(msgpack.packb(to_state_dict(tree)))


def load_state(path: str):
    """The tree of a msgpack file (dicts and arrays)."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


# ------------------------------------------------------------------ bundles
def _counters(model: nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in model.state_dict().items()
            if k.endswith(COUNTER)}


def _jax_model(model: nn.Module, to_jax) -> Dict:
    params, stats = to_jax(model.state_dict())
    return {"params": params, "batch_stats": stats}


def _g_bundle(state, epoch: int, fmt: str) -> Dict:
    g = state.generator
    if fmt == "pth":
        return {"G_model": g.state_dict(),
                "G_optimizer": state.g_opt.state_dict(), "G_epoch": epoch}
    return {"G_model": _jax_model(g, generator_state_to_jax),
            "G_optimizer": adam_to_jax(g, state.g_opt, generator_rules()),
            "G_epoch": epoch, "G_torch_counters": _counters(g)}


def _d_bundle(state, epoch: int, fmt: str) -> Dict:
    out = {}
    for i, (d, opt) in enumerate(zip(state.discriminators, state.d_opts), 1):
        if fmt == "pth":
            out[f"D_model{i}"] = d.state_dict()
            out[f"D_optimizer{i}"] = opt.state_dict()
            continue
        out[f"D_model{i}"] = _jax_model(d, discriminator_state_to_jax)
        out[f"D_optimizer{i}"] = adam_to_jax(
            d, opt, discriminator_rules_of(d.state_dict()))
        out[f"D_torch_counters{i}"] = _counters(d)
    out["D_epoch"] = epoch
    return out


def save(checkpoint_dir: str, state, epoch: int, category: str,
         fmt: str = "pth") -> Tuple[str, str]:
    """Write the G and D bundles of a ``GANState`` as ``fmt`` (``"pth"`` or
    ``"msgpack"``); returns their paths."""
    if fmt not in FORMATS:
        raise ValueError(f"checkpoint format {fmt!r} (one of {FORMATS})")
    os.makedirs(checkpoint_dir, exist_ok=True)
    name = os.path.join(checkpoint_dir, f"{epoch}_{category}")
    paths = name + "_G." + fmt, name + "_D." + fmt
    bundles = _g_bundle(state, epoch, fmt), _d_bundle(state, epoch, fmt)
    for path, bundle in zip(paths, bundles):
        if fmt == "pth":
            torch.save(bundle, path)
        else:
            save_state(path, bundle)
    return paths


def _read(path: str) -> Tuple[Dict, bool]:
    """(bundle, is msgpack) of a checkpoint file."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found at {path}")
    if path.endswith(".msgpack"):
        return load_state(path), True
    return torch.load(path, map_location="cpu", weights_only=True), False


def _two_k(model: nn.Module) -> int:
    """The merge convs' slot count of a generator (2 * (num_k // 2))."""
    return model.bilateral1.upsample_cov[0].conv2.conv.weight.shape[-1]


def _load_jax_model(model: nn.Module, entry: Dict, counters, from_jax,
                    **kw) -> None:
    sd = from_jax(entry["params"], entry["batch_stats"], **kw)
    for k, v in (counters or {}).items():
        sd[k] = torch.from_numpy(np.array(v, np.int64))
    model.load_state_dict(sd)


def _load_g(raw: Dict, jax_format: bool, model: nn.Module, opt=None) -> int:
    if not jax_format:
        model.load_state_dict(strip_module(
            raw["G_model"] if "G_model" in raw else raw))
        if opt is not None:
            opt.load_state_dict(raw["G_optimizer"])
        return int(raw.get("G_epoch", 0))
    two_k = _two_k(model)
    _load_jax_model(model, raw["G_model"], raw.get("G_torch_counters"),
                    generator_state_from_jax, num_k=two_k)
    if opt is not None and raw.get("G_optimizer") is not None:
        opt.load_state_dict(adam_from_jax(raw["G_optimizer"], model, opt,
                                          generator_rules(), two_k))
    return int(raw.get("G_epoch", 0))


def load_generator(path: str, model: nn.Module) -> int:
    """Load a G bundle (reference ``.pth``, a bare state dict, or a JAX
    ``.msgpack``) into ``model``; returns ``G_epoch`` (0 when absent)."""
    return _load_g(*_read(path), model)


def load(path_g: str, path_d: str, state) -> int:
    """Restore both bundles into a ``GANState`` (models and optimizers),
    each file read by its extension; both files are required, as in the
    reference loader (models/PDGNet_v2.py:333-382). Returns ``G_epoch``."""
    (raw_g, g_jax), (raw_d, d_jax) = _read(path_g), _read(path_d)
    epoch = _load_g(raw_g, g_jax, state.generator, state.g_opt)
    for i, (d, opt) in enumerate(zip(state.discriminators, state.d_opts), 1):
        if not d_jax:
            d.load_state_dict(strip_module(raw_d[f"D_model{i}"]))
            opt.load_state_dict(raw_d[f"D_optimizer{i}"])
            continue
        _load_jax_model(d, raw_d[f"D_model{i}"],
                        raw_d.get(f"D_torch_counters{i}"),
                        discriminator_state_from_jax)
        if raw_d.get(f"D_optimizer{i}") is not None:
            opt.load_state_dict(adam_from_jax(
                raw_d[f"D_optimizer{i}"], d, opt,
                discriminator_rules_of(d.state_dict())))
    return epoch
