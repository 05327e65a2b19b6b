"""Weights between the JAX package's flax trees and the port's
``state_dict`` (port of pdgn_tpu/convert_ckpt.py:47-157).

The port's parameter names and layouts ARE the reference torch ones, so a
reference ``.pth`` needs no conversion. :func:`generator_state_from_jax` and
:func:`discriminator_state_from_jax` go the other way round from
``pdgn_tpu.convert_ckpt.convert_generator``/``convert_discriminator``: flax
``params``/``batch_stats`` (as numpy) -> a ``state_dict``, including the
un-permutation of the window conv's block-ordered batch norm;
:func:`edge_conv_state_from_jax` does the same for the plain ``EdgeConv``.
Any tree shaped like ``params`` converts the same way (an Adam moment, for
instance).

This module keeps its own copy of the rules: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pdgn_tpu_torch.models.generator import _block_channel_perm


def generator_rules() -> List[Tuple[str, str, str]]:
    """(torch_prefix, kind, flax_dotted_prefix) for the v2 generator
    (copy of ``pdgn_tpu.convert_ckpt.generator_rules``)."""
    rules: List[Tuple[str, str, str]] = [
        ("fc1.0", "linear", "fc1.dense"),
        ("fc1.1", "bn", "fc1_bn.bn"),
    ]
    for i in range(1, 5):
        b = f"bilateral{i}"
        uc = f"{b}.upsample_cov.0" if i == 1 else f"{b}.upsample_cov"
        ours = f"{b}.upsample_cov"
        rules += [
            (f"{uc}.conv2.conv", "merge", f"{ours}.TorchDense_0.dense"),
            (f"{uc}.conv2.bn", "bn", f"{ours}.BatchNorm_0.bn"),
            (f"{uc}.inte_conv_hk.0", "window", f"{ours}._WindowConv_0.conv"),
            (f"{uc}.inte_conv_hk.1", "bn_block",
             f"{ours}._WindowConv_0.BatchNorm_0.bn"),
        ]
        if i == 1:
            rules.append((f"{b}.upsample_cov.1", "bn", f"{b}.bn_uc.bn"))
        else:
            rules += [
                (f"{uc}.conv_fea.0", "conv1x1", f"{ours}.conv_fea.dense"),
                (f"{uc}.conv_fea.1", "bn", f"{ours}.bn_fea.bn"),
                (f"{uc}.conv_xyz.0", "conv1x1", f"{ours}.conv_xyz.dense"),
                (f"{uc}.conv_xyz.1", "bn", f"{ours}.bn_xyz.bn"),
                (f"{uc}.conv_all.0", "conv1x1", f"{ours}.conv_all1.dense"),
                (f"{uc}.conv_all.1", "bn", f"{ours}.bn_all1.bn"),
                (f"{uc}.conv_all.3", "conv1x1", f"{ours}.conv_all2.dense"),
                (f"{uc}.conv_all.4", "bn", f"{ours}.bn_all2.bn"),
                (f"{b}.bn_uc", "bn", f"{b}.bn_uc.bn"),
            ]
        gb = f"{b}._GlobalBranch_0"
        rules += [
            (f"{b}.fc.0", "linear", f"{gb}.fc1.dense"),
            (f"{b}.fc.1", "bn", f"{gb}.bn_fc1.bn"),
            (f"{b}.fc.3", "linear", f"{gb}.fc2.dense"),
            (f"{b}.fc.4", "bn", f"{gb}.bn_fc2.bn"),
        ]
        if i < 4:
            rules += [
                (f"{b}.g_fc.0", "linear", f"{gb}.g_fc.dense"),
                (f"{b}.g_fc.1", "bn", f"{gb}.bn_g.bn"),
            ]
    for i in range(1, 5):
        for j, t in enumerate((0, 2, 4)):
            rules.append((f"mlp{i}.{t}", "conv1d",
                          f"mlp{i}.TorchDense_{j}.dense"))
    return rules


def discriminator_rules(num_conv: int, num_linear: int
                        ) -> List[Tuple[str, str, str]]:
    """Rules for one discriminator with ``num_conv`` point convs and
    ``num_linear`` head layers (the reference's ``fc1`` Sequential: Conv1d
    at 0, 3, 6, ..., BN at 1, 4, 7, ...; ``mlp``: Linear at 0, 2, 4, ...;
    flax ``conv{n}`` blocks and ``fc{j}``/``fc_out``)."""
    rules: List[Tuple[str, str, str]] = []
    for n in range(num_conv):
        rules.append((f"fc1.{3 * n}", "conv1d",
                      f"conv{n + 1}.TorchDense_0.dense"))
        rules.append((f"fc1.{3 * n + 1}", "bn", f"conv{n + 1}.BatchNorm_0.bn"))
    names = [f"fc{j}" for j in range(1, num_linear)] + ["fc_out"]
    for j, name in enumerate(names):
        rules.append((f"mlp.{2 * j}", "linear", f"{name}.dense"))
    return rules


# flax kernel -> torch weight (inverses of convert_ckpt._WEIGHT_T)
def _w_linear(k):
    return k.T


def _w_conv1d(k):
    return k.T[:, :, None]


def _w_conv1x1(k):
    return k.T[:, :, None, None]


def _w_window(k):
    # flax HWIO (1, W, in, out) -> torch (out, in, 1, W)
    return np.transpose(k, (3, 2, 0, 1))


def _w_merge(k, two_k):
    # slot-major (2k*2C, 2F) -> torch (2F, 2C, 1, 2k)
    rows, two_f = k.shape
    return np.transpose(k.reshape(two_k, rows // two_k, two_f),
                        (2, 1, 0))[:, :, None, :]


def _get(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def _unblock(v):
    """Block channel order -> reference order: ``ref[perm[p]] = blk[p]``."""
    out = np.empty_like(v)
    out[np.asarray(_block_channel_perm(v.shape[0]))] = v
    return out


def _state_from_jax(rules, params: Dict, batch_stats: Dict,
                    two_k: int = 0) -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}
    for prefix, kind, fp in rules:
        if kind in ("bn", "bn_block"):
            t = _unblock if kind == "bn_block" else (lambda v: v)
            sd[f"{prefix}.weight"] = t(_get(params, f"{fp}.scale"))
            sd[f"{prefix}.bias"] = t(_get(params, f"{fp}.bias"))
            sd[f"{prefix}.running_mean"] = t(_get(batch_stats, f"{fp}.mean"))
            sd[f"{prefix}.running_var"] = t(_get(batch_stats, f"{fp}.var"))
            sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
            continue
        kernel = _get(params, f"{fp}.kernel")
        if kind == "merge":
            w = _w_merge(kernel, two_k)
        else:
            w = {"linear": _w_linear, "conv1d": _w_conv1d,
                 "conv1x1": _w_conv1x1, "window": _w_window}[kind](kernel)
        sd[f"{prefix}.weight"] = w
        sd[f"{prefix}.bias"] = _get(params, f"{fp}.bias")
    return {name: torch.from_numpy(np.array(v, copy=True))
            for name, v in sd.items()}


def generator_state_from_jax(params: Dict, batch_stats: Dict,
                             num_k: int = 20) -> Dict[str, torch.Tensor]:
    """Flax generator ``params``/``batch_stats`` -> the port's
    ``state_dict`` (``num_batches_tracked`` set to 0)."""
    return _state_from_jax(generator_rules(), params, batch_stats,
                           2 * (num_k // 2))


def edge_conv_rules() -> List[Tuple[str, str, str]]:
    """Rules for ``models.generator.EdgeConv`` against the flax
    ``EdgeConv`` (``conv/dense`` and ``BatchNorm_0/bn``)."""
    return [("conv.conv", "conv1x1", "conv.dense"),
            ("conv.bn", "bn", "BatchNorm_0.bn")]


def edge_conv_state_from_jax(params: Dict, batch_stats: Dict
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``EdgeConv`` ``params``/``batch_stats`` -> the port's
    ``state_dict`` (``num_batches_tracked`` set to 0)."""
    return _state_from_jax(edge_conv_rules(), params, batch_stats)


def discriminator_state_from_jax(params: Dict, batch_stats: Dict
                                 ) -> Dict[str, torch.Tensor]:
    """Flax discriminator ``params``/``batch_stats`` -> the port's
    ``state_dict`` (``num_batches_tracked`` set to 0)."""
    num_conv = sum(1 for name in params if name.startswith("conv"))
    num_linear = len(params) - num_conv
    return _state_from_jax(discriminator_rules(num_conv, num_linear), params,
                           batch_stats)
