"""The port's reference-checkpoint converter (``pdgn_tpu_torch.convert_ckpt``
``convert_files``/``main``) against the JAX package's.

A reference-layout ``.pth`` pair is built from the port's own full-width
models (their names are the reference's): ``PointGenerator`` at 2048 points
and num_k 20 and the four discriminators, keys with the DataParallel
``module.`` prefix, ``G_epoch``/``D_epoch`` 7, and each model's Adam (lr
1e-4, betas 0.5/0.999) after one step on seeded random gradients, one
generator parameter left without a gradient (never stepped). No forward
runs.

* Both converters write the same file names and bytes, so every leaf is
  equal, dtype included (read back with flax's reader).
* ``python -m pdgn_tpu_torch.convert_ckpt`` in a process of its own writes
  the same bytes and imports neither JAX nor the JAX package
  (``-X importtime`` lists every module it imports).
* The port's ``train.checkpoint.load`` takes the converted bundles: every
  weight and running statistic equal to the source's (``num_batches_tracked``
  is not converted: 0), every Adam moment equal to the source optimizer's
  for the same parameter (which catches a parameter order that differs
  from the optimizer's), the unstepped parameter's zero, ``step`` 1.
* A ``.pth`` that holds a pickled object is refused.
"""

import argparse
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from torch_port_util import one_torch_thread  # noqa: F401

from pdgn_tpu.convert_ckpt import convert_files as jax_convert_files
from pdgn_tpu_torch.convert_ckpt import convert_files
from pdgn_tpu_torch.models.discriminator import discriminators
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.train import TrainConfig, init_state
from pdgn_tpu_torch.train.checkpoint import load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 7
UNSTEPPED = "bilateral2.fc.0.weight"


def _models(seed: int):
    torch.manual_seed(seed)
    return PointGenerator(num_point=2048, num_k=20), discriminators()


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """The reference-layout pair on disk and the models and optimizers it
    was written from."""
    g, ds = _models(0)
    opts = [torch.optim.Adam(m.parameters(), lr=1e-4, betas=(0.5, 0.999))
            for m in (g,) + ds]
    rng = np.random.RandomState(1)
    for m in (g,) + ds:
        for name, p in m.named_parameters():
            if m is g and name == UNSTEPPED:
                continue
            p.grad = torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32))
    for opt in opts:
        opt.step()

    def dp(sd):
        return {"module." + k: v for k, v in sd.items()}

    root = tmp_path_factory.mktemp("convert")
    pth_g, pth_d = str(root / "7_chair_G.pth"), str(root / "7_chair_D.pth")
    torch.save({"G_model": dp(g.state_dict()),
                "G_optimizer": opts[0].state_dict(), "G_epoch": EPOCH}, pth_g)
    bundle = {"D_epoch": EPOCH}
    for i, (d, opt) in enumerate(zip(ds, opts[1:]), 1):
        bundle[f"D_model{i}"] = dp(d.state_dict())
        bundle[f"D_optimizer{i}"] = opt.state_dict()
    torch.save(bundle, pth_d)
    return {"root": root, "pth": (pth_g, pth_d), "models": (g,) + ds,
            "opts": opts}


@pytest.fixture(scope="module")
def converted(source):
    """Both converters' outputs: {"port": (G, D), "jax": (G, D)}."""
    out = {}
    for tag, fn in (("port", convert_files), ("jax", jax_convert_files)):
        out[tag] = fn(*source["pth"], str(source["root"] / tag), "chair")
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_tree(a, b, where=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
        return
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(b, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def test_files_and_leaves_equal_jax(converted):
    """Same file names; the bytes are equal, and so every key set and leaf
    (value, dtype, shape, and numpy scalar against 0-d array) as flax reads
    them."""
    for ours, want in zip(converted["port"], converted["jax"]):
        assert os.path.basename(ours) == os.path.basename(want)
        tree_ours = serialization.msgpack_restore(_read(ours))
        tree_want = serialization.msgpack_restore(_read(want))
        _assert_same_tree(tree_ours, tree_want)
        assert _read(ours) == _read(want)
    g = serialization.msgpack_restore(_read(converted["port"][0]))
    d = serialization.msgpack_restore(_read(converted["port"][1]))
    assert set(g) == {"G_model", "G_optimizer", "G_epoch"}
    assert set(d) == ({"D_epoch"} | {f"D_model{i}" for i in range(1, 5)}
                      | {f"D_optimizer{i}" for i in range(1, 5)})
    assert g["G_epoch"] == EPOCH and d["D_epoch"] == EPOCH
    assert g["G_optimizer"]["0"]["count"] == np.int32(1)


def test_module_command_imports_no_jax(source, converted, tmp_path):
    """``python -m pdgn_tpu_torch.convert_ckpt`` prints both paths, writes
    the in-process converter's bytes and imports no JAX module."""
    pth_g, pth_d = source["pth"]
    out_dir = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "pdgn_tpu_torch.convert_ckpt", "--ckpt_g", pth_g, "--ckpt_d",
         pth_d, "--out_dir", out_dir, "--category", "chair"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    paths = proc.stdout.split()
    assert paths == [os.path.join(out_dir, f"{EPOCH}_chair_G.msgpack"),
                     os.path.join(out_dir, f"{EPOCH}_chair_D.msgpack")]
    for ours, want in zip(paths, converted["port"]):
        assert _read(ours) == _read(want)
    imported = [ln.rsplit("|", 1)[1].strip() for ln in
                proc.stderr.splitlines() if ln.startswith("import time:")]
    assert "torch" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "pdgn_tpu", "flax")]


def test_port_loads_converted_bundles(source, converted):
    """``train.checkpoint.load`` gives back the source tensors exactly."""
    g, ds = _models(5)
    state = init_state(g, ds, TrainConfig())
    epoch = load(*converted["port"], state)
    assert epoch == EPOCH
    loaded = (state.generator,) + state.discriminators
    for m_src, m_got in zip(source["models"], loaded):
        got = m_got.state_dict()
        for k, v in m_src.state_dict().items():
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == 0, k
            else:
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    for m_src, o_src, m_got, o_got in zip(
            source["models"], source["opts"], loaded,
            (state.g_opt,) + state.d_opts):
        for (name, p_src), p_got in zip(m_src.named_parameters(),
                                        m_got.parameters()):
            s_got = o_got.state[p_got]
            assert float(s_got["step"]) == 1.0, name
            if m_src is source["models"][0] and name == UNSTEPPED:
                assert not o_src.state.get(p_src)
                assert not s_got["exp_avg"].any()
                assert not s_got["exp_avg_sq"].any()
                continue
            s_src = o_src.state[p_src]
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s_got[key], s_src[key]), (name, key)


def test_pickled_object_refused(source, tmp_path):
    """``weights_only=True``: a bundle holding any object other than
    tensors, containers and numbers does not load."""
    raw = torch.load(source["pth"][0], map_location="cpu",
                     weights_only=True)
    raw["G_args"] = argparse.Namespace(num_point=2048)
    bad = str(tmp_path / "bad_G.pth")
    torch.save(raw, bad)
    with pytest.raises(pickle.UnpicklingError):
        convert_files(bad, source["pth"][1], str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")
