"""Weights and Adam state between the JAX package's flax trees and the
port's ``state_dict``, and the reference-checkpoint converter command
(port of pdgn_tpu/convert_ckpt.py).

The port's parameter names and layouts ARE the reference torch ones, so a
reference ``.pth`` needs no conversion. :func:`generator_state_from_jax` and
:func:`discriminator_state_from_jax` go the other way round from
``pdgn_tpu.convert_ckpt.convert_generator``/``convert_discriminator``: flax
``params``/``batch_stats`` (as numpy) -> a ``state_dict``, including the
un-permutation of the window conv's block-ordered batch norm;
:func:`edge_conv_state_from_jax` does the same for the plain ``EdgeConv``.
:func:`generator_state_to_jax` and :func:`discriminator_state_to_jax` are
their inverses (``convert_generator``'s direction), and
:func:`adam_to_jax`/:func:`adam_from_jax` map torch's ``Adam`` state to
optax's ``adam`` state and back (``convert_adam``'s direction and its
inverse): the moments take the weights' layouts, optax ``count`` is torch
``step``; :func:`adam_state_to_jax` reads a raw optimizer ``state_dict``
with no model built. All of them run on one table, :func:`tensor_map`.

The command (:func:`main`, ``pdgn_tpu.convert_ckpt``'s flags) turns a
reference ``.pth`` G/D pair, e.g. the published ``600_chair_G.pth`` /
``600_chair_D.pth``, into the JAX package's two msgpack bundles::

    python -m pdgn_tpu_torch.convert_ckpt --ckpt_g 600_chair_G.pth \
        --ckpt_d 600_chair_D.pth --out_dir converted/ --category chair

writes ``converted/600_chair_G.msgpack`` and ``_D.msgpack`` (keys
``G_model``, ``G_optimizer``, ``G_epoch``; ``D_epoch``, ``D_model1-4``,
``D_optimizer1-4``), loadable by ``pdgn_tpu.train.checkpoint.load``, by the
port's ``train.checkpoint.load`` and by both CLIs' ``--pretrain_model_G/_D``.

This module keeps its own copy of the rules: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

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


# torch weight <-> flax kernel: (to_jax, from_jax) per rule kind
def _merge_to_jax(w):
    # torch (2F, 2C, 1, 2k) -> slot-major (2k*2C, 2F)
    two_f, two_c, _, two_k = w.shape
    return np.transpose(w[:, :, 0, :], (2, 1, 0)).reshape(two_k * two_c,
                                                          two_f)


def _merge_from_jax(k, two_k):
    rows, two_f = k.shape
    return np.transpose(k.reshape(two_k, rows // two_k, two_f),
                        (2, 1, 0))[:, :, None, :]


_WEIGHTS = {
    "linear": (lambda w: w.T, lambda k: k.T),
    "conv1d": (lambda w: w[:, :, 0].T, lambda k: k.T[:, :, None]),
    "conv1x1": (lambda w: w[:, :, 0, 0].T, lambda k: k.T[:, :, None, None]),
    # torch (out, in, 1, W) <-> flax HWIO (1, W, in, out)
    "window": (lambda w: np.transpose(w, (2, 3, 1, 0)),
               lambda k: np.transpose(k, (3, 2, 0, 1))),
}


def _block(v):
    """Reference channel order -> block order: ``blk[p] = ref[perm[p]]``."""
    return v[np.asarray(_block_channel_perm(v.shape[0]))]


def _unblock(v):
    """Block channel order -> reference order: ``ref[perm[p]] = blk[p]``."""
    out = np.empty_like(v)
    out[np.asarray(_block_channel_perm(v.shape[0]))] = v
    return out


def _same(v):
    return v


def tensor_map(rules, two_k: int = 0):
    """One entry per converted tensor: ``(torch name, "params" or
    "batch_stats", flax dotted path, to_jax, from_jax)``. ``two_k`` is the
    merge convs' slot count (2 * (num_k // 2)); BN's
    ``num_batches_tracked`` has no flax counterpart and no entry."""
    out = []
    for prefix, kind, fp in rules:
        if kind in ("bn", "bn_block"):
            t = (_block, _unblock) if kind == "bn_block" else (_same, _same)
            out += [(f"{prefix}.weight", "params", f"{fp}.scale", *t),
                    (f"{prefix}.bias", "params", f"{fp}.bias", *t),
                    (f"{prefix}.running_mean", "batch_stats", f"{fp}.mean",
                     *t),
                    (f"{prefix}.running_var", "batch_stats", f"{fp}.var",
                     *t)]
            continue
        if kind == "merge":
            t = (_merge_to_jax, lambda k: _merge_from_jax(k, two_k))
        else:
            t = _WEIGHTS[kind]
        out += [(f"{prefix}.weight", "params", f"{fp}.kernel", *t),
                (f"{prefix}.bias", "params", f"{fp}.bias", _same, _same)]
    return out


COUNTER = "num_batches_tracked"   # BN's counter: no flax counterpart
_BUFFERS = ("running_mean", "running_var", COUNTER)


def strip_module(sd: Dict) -> Dict:
    """Drop the ``module.`` prefix of DataParallel state dicts."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _get(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32, copy=True))


def _state_from_jax(rules, params: Dict, batch_stats: Dict,
                    two_k: int = 0) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    trees = {"params": params, "batch_stats": batch_stats}
    for name, tree, fp, _, from_jax in tensor_map(rules, two_k):
        sd[name] = _tensor(from_jax(_get(trees[tree], fp)))
        if name.endswith(".running_var"):
            sd[name[:-len("running_var")] + COUNTER] = (
                torch.zeros((), dtype=torch.int64))
    return sd


def _state_to_jax(rules, sd: Dict) -> Tuple[Dict, Dict]:
    """``sd`` through :func:`tensor_map` in ``sd``'s own order (the JAX
    converter's, so the trees nest alike), BN's ``num_batches_tracked``
    dropped; a key without a rule, or a rule without its key, raises."""
    table = {name: (tree, fp, to_jax)
             for name, tree, fp, to_jax, _ in tensor_map(rules)}
    missing = set(table) - set(sd)
    if missing:
        raise KeyError(f"torch checkpoint lacks keys: {sorted(missing)[:5]}")
    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {},
                                               "batch_stats": {}}
    for name, v in sd.items():
        if name.endswith(COUNTER):
            continue
        if name not in table:
            raise KeyError(f"unmapped torch key: {name}")
        tree, fp, to_jax = table[name]
        flat[tree][fp] = np.ascontiguousarray(to_jax(_numpy(v)))
    return _nest(flat["params"]), _nest(flat["batch_stats"])


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


def discriminator_rules_of(sd: Dict) -> List[Tuple[str, str, str]]:
    """:func:`discriminator_rules` for the discriminator whose
    ``state_dict`` is ``sd`` (Conv1d weights in ``fc1``, Linear in
    ``mlp``)."""
    num_conv = sum(1 for k, v in sd.items() if k.startswith("fc1.")
                   and k.endswith(".weight") and v.ndim == 3)
    num_linear = sum(1 for k in sd if k.startswith("mlp.")
                     and k.endswith(".weight"))
    return discriminator_rules(num_conv, num_linear)


def generator_state_to_jax(sd: Dict) -> Tuple[Dict, Dict]:
    """The port's generator ``state_dict`` -> flax ``(params,
    batch_stats)`` as numpy (``pdgn_tpu.convert_ckpt.convert_generator``'s
    layouts: block-ordered window BN, slot-major merge)."""
    return _state_to_jax(generator_rules(), sd)


def discriminator_state_to_jax(sd: Dict) -> Tuple[Dict, Dict]:
    """The port's discriminator ``state_dict`` -> flax ``(params,
    batch_stats)`` as numpy."""
    return _state_to_jax(discriminator_rules_of(sd), sd)


def _param_index(opt: torch.optim.Optimizer) -> Dict[int, int]:
    """id(parameter) -> its index in ``opt.state_dict()``."""
    params = [p for group in opt.param_groups for p in group["params"]]
    return {id(p): i for i, p in enumerate(params)}


def adam_state_to_jax(sd: Dict, opt_sd: Dict, rules) -> Dict:
    """A raw torch ``Adam`` ``state_dict`` (``opt_sd``, as a ``.pth``
    holds it) of the model whose ``state_dict`` is ``sd`` -> the state dict
    of optax's ``adam`` (``chain(scale_by_adam, scale_by_learning_rate)``):
    ``{"0": {"count", "mu", "nu"}, "1": {}}``, with no model built (port of
    ``pdgn_tpu.convert_ckpt._Mapper.convert_adam``). The optimizer's
    parameters are ``sd``'s keys less the BN buffers, in order; the moments
    take the weights' layouts, a parameter never stepped gets zeros, and
    ``count`` is the largest ``step`` (an ``np.int32``)."""
    table = {name: (fp, to_jax) for name, tree, fp, to_jax, _
             in tensor_map(rules) if tree == "params"}
    names = [k for k in sd if not k.endswith(_BUFFERS)]
    order = [pid for group in opt_sd["param_groups"]
             for pid in group["params"]]
    if len(order) != len(names):
        raise ValueError(f"optimizer/param count mismatch: {len(order)} vs "
                         f"{len(names)}")
    mu, nu, count = {}, {}, 0
    for pid, name in zip(order, names):
        if name not in table:
            raise KeyError(f"parameter without a rule: {name}")
        fp, to_jax = table[name]
        s = opt_sd["state"].get(pid, {})
        if s:
            ea, eas = _numpy(s["exp_avg"]), _numpy(s["exp_avg_sq"])
            count = max(count, int(np.asarray(s["step"])))
        else:
            ea = eas = np.zeros(tuple(sd[name].shape), np.float32)
        mu[fp] = np.ascontiguousarray(to_jax(ea))
        nu[fp] = np.ascontiguousarray(to_jax(eas))
    return {"0": {"count": np.int32(count), "mu": _nest(mu),
                  "nu": _nest(nu)}, "1": {}}


def adam_to_jax(model: torch.nn.Module, opt: torch.optim.Optimizer,
                rules) -> Dict:
    """``opt``'s Adam state for ``model`` (built on ``model.parameters()``)
    -> optax ``adam``'s state dict, as :func:`adam_state_to_jax`, with
    ``count`` a 0-d int32 array as optax keeps it."""
    out = adam_state_to_jax(model.state_dict(), opt.state_dict(), rules)
    out["0"]["count"] = np.asarray(out["0"]["count"])
    return out


def adam_from_jax(opt_state: Dict, model: torch.nn.Module,
                  opt: torch.optim.Optimizer, rules, two_k: int = 0) -> Dict:
    """optax ``adam``'s state dict -> a ``state_dict`` for ``opt`` (its own
    ``param_groups``): each parameter's ``exp_avg``/``exp_avg_sq`` from
    ``mu``/``nu`` in torch layout, ``step`` = ``count``. ``count`` 0 (never
    stepped) gives an empty state, as a fresh optimizer has."""
    adam = opt_state["0"]
    count = int(np.asarray(adam["count"]))
    table = {name: (fp, from_jax) for name, tree, fp, _, from_jax
             in tensor_map(rules, two_k) if tree == "params"}
    index = _param_index(opt)
    state = {}
    if count:
        for name, p in model.named_parameters():
            fp, from_jax = table[name]
            state[index[id(p)]] = {
                "step": torch.tensor(float(count)),
                "exp_avg": _tensor(from_jax(_get(adam["mu"], fp))),
                "exp_avg_sq": _tensor(from_jax(_get(adam["nu"], fp)))}
    return {"state": state, "param_groups": opt.state_dict()["param_groups"]}


# ------------------------------------------------------------ the command
def convert_generator(sd: Dict, opt_sd: Optional[Dict] = None
                      ) -> Tuple[Dict, Optional[Dict]]:
    """A reference generator ``state_dict`` (and its raw Adam
    ``state_dict``) -> ``({"params", "batch_stats"}, adam state or None)``
    in the JAX package's layout."""
    sd = strip_module(sd)
    params, stats = generator_state_to_jax(sd)
    opt = adam_state_to_jax(sd, opt_sd, generator_rules()) if opt_sd else None
    return {"params": params, "batch_stats": stats}, opt


def convert_discriminator(sd: Dict, opt_sd: Optional[Dict] = None
                          ) -> Tuple[Dict, Optional[Dict]]:
    """:func:`convert_generator` for one discriminator."""
    sd = strip_module(sd)
    rules = discriminator_rules_of(sd)
    params, stats = _state_to_jax(rules, sd)
    opt = adam_state_to_jax(sd, opt_sd, rules) if opt_sd else None
    return {"params": params, "batch_stats": stats}, opt


def convert_files(ckpt_g: str, ckpt_d: str, out_dir: str,
                  category: str = "chair") -> Tuple[str, str]:
    """Convert a reference G/D ``.pth`` pair to the JAX package's msgpack
    bundles ``<out_dir>/<epoch>_<category>_{G,D}.msgpack``; returns their
    paths. The files are read with ``weights_only=True``: a file holding
    any pickled object other than tensors, containers and numbers is
    refused."""
    from pdgn_tpu_torch.train.checkpoint import save_state

    raw_g = torch.load(ckpt_g, map_location="cpu", weights_only=True)
    raw_d = torch.load(ckpt_d, map_location="cpu", weights_only=True)

    g_model, g_opt = convert_generator(raw_g["G_model"],
                                       raw_g.get("G_optimizer"))
    epoch = int(raw_g.get("G_epoch", 0))
    bundle_g = {"G_model": g_model, "G_optimizer": g_opt, "G_epoch": epoch}

    bundle_d = {"D_epoch": int(raw_d.get("D_epoch", epoch))}
    for i in range(1, 5):
        model, opt = convert_discriminator(raw_d[f"D_model{i}"],
                                           raw_d.get(f"D_optimizer{i}"))
        bundle_d[f"D_model{i}"] = model
        bundle_d[f"D_optimizer{i}"] = opt

    os.makedirs(out_dir, exist_ok=True)
    path_g = os.path.join(out_dir, f"{epoch}_{category}_G.msgpack")
    path_d = os.path.join(out_dir, f"{epoch}_{category}_D.msgpack")
    save_state(path_g, bundle_g)
    save_state(path_d, bundle_d)
    return path_g, path_d


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Convert reference .pth checkpoints to the JAX "
        "package's msgpack bundles")
    ap.add_argument("--ckpt_g", required=True)
    ap.add_argument("--ckpt_d", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--category", default="chair")
    args = ap.parse_args(argv)
    path_g, path_d = convert_files(args.ckpt_g, args.ckpt_d, args.out_dir,
                                   args.category)
    print(path_g)
    print(path_d)


if __name__ == "__main__":
    main()
