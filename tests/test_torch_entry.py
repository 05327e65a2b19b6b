"""Entry points of the port on the CPU: the CLI's sample phase, the CUDA
default that fails loudly without a card, the sampler's frozen running
statistics, reference-format checkpoints, import hygiene and the absence
of any switch that routes around a kernel."""

import os
import pathlib
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import rel

from pdgn_tpu_torch import cli
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.train.checkpoint import load_generator
from pdgn_tpu_torch.train.generate import build_generator, generate
from pdgn_tpu_torch.train.sampler import make_sampler

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pdgn_tpu_torch"
SMALL = dict(base_points=16)


def _cli_args(tmp_path, *extra):
    return ["--network", "PDGNet_v2", "--model_dir", "m",
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--save_dir", str(tmp_path / "out"), "--base_points", "16",
            "--num_samples", "5", "--batch_size", "2", *extra]


def test_cli_sample_writes_clouds_on_cpu(tmp_path):
    _lib.LAUNCHES.clear()
    cli.main(_cli_args(tmp_path, "--phase", "sample", "--device", "cpu"))
    out = np.load(tmp_path / "out" / "samples_m_5.npy")
    assert out.shape == (5, 256, 3)
    assert np.isfinite(out).all()
    assert sum(_lib.LAUNCHES.values()) == 0


def test_cli_default_device_fails_loudly_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_cli_args(tmp_path, "--phase", "sample"))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("phase", ["train", "test"])
def test_cli_unported_phases_exit_nonzero(tmp_path, phase, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_cli_args(tmp_path, "--phase", phase, "--device", "cpu"))
    assert exc.value.code != 0
    assert "not yet ported" in capsys.readouterr().out


def test_generate_is_deterministic_and_keeps_running_stats():
    model = build_generator(3, "cpu", **SMALL)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    a = generate(3, 2, seed=3, device="cpu", model=model)
    b = generate(3, 2, seed=3, device="cpu", **SMALL)
    assert a.shape == (3, 256, 3)
    np.testing.assert_array_equal(a, b)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert model.training  # the sampler restores the module's mode


def test_sampler_uses_batch_statistics():
    """Sampling normalises with the batch's statistics: the same noise row
    gives a different cloud inside a different batch."""
    model = build_generator(0, "cpu", **SMALL)
    sample = make_sampler(model)
    z = torch.randn(4, 128, generator=torch.Generator().manual_seed(1))
    full = sample(4, z=z)[3]
    half = sample(2, z=z[:2])[3]
    assert rel(full[:2], half) > 1e-3


def _save_reference_format(path, model, epoch=0):
    """A G bundle as the reference writes it, from a DataParallel model
    (models/PDGNet_v2.py:384-408): 'module.'-prefixed keys, the Adam
    optimizer's state dict after a step, and the epoch."""
    path.parent.mkdir(parents=True, exist_ok=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.0, 0.99))
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    torch.save({"G_model": sd, "G_optimizer": opt.state_dict(),
                "G_epoch": epoch}, path)
    return str(path)


def test_reference_checkpoint_round_trip(tmp_path):
    model = build_generator(5, "cpu", **SMALL)
    path = _save_reference_format(tmp_path / "7_chair_G.pth", model, 7)
    other = PointGenerator(**SMALL)
    assert load_generator(path, other) == 7
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    with pytest.raises(FileNotFoundError):
        load_generator(str(tmp_path / "missing.pth"), other)


class _NotAWeight:
    pass


def test_checkpoint_refuses_pickled_objects(tmp_path):
    """Checkpoints load with ``weights_only=True``: a file that holds an
    arbitrary pickled object is refused, not executed."""
    model = build_generator(5, "cpu", **SMALL)
    path = tmp_path / "odd_G.pth"
    torch.save({"G_model": model.state_dict(), "G_epoch": 1,
                "extra": _NotAWeight()}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_generator(str(path), PointGenerator(**SMALL))


def test_cli_loads_pretrained_generator(tmp_path):
    model = build_generator(11, "cpu", **SMALL)
    ckpt_dir = tmp_path / "ckpt" / "m" / "PDGNet_v2"
    _save_reference_format(ckpt_dir / "g.pth", model)
    cli.main(_cli_args(tmp_path, "--phase", "sample", "--device", "cpu",
                       "--pretrain_model_G", "g.pth", "--seed", "4"))
    got = np.load(tmp_path / "out" / "samples_m_5.npy")
    want = generate(5, 2, seed=4, device="cpu", model=model)
    np.testing.assert_array_equal(got, want)


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX, flax or
    the JAX package."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pdgn_tpu')]\n"
            "print(len(bad), bad[:5])\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 20


def test_no_environment_switch_on_the_kernel_path():
    """No environment variable routes around a kernel: the package reads
    no ``os.environ`` / ``os.getenv`` at all."""
    pattern = re.compile(r"os\.environ|getenv|PDGN_DISABLE")
    hits = [str(p) for p in PKG.rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == []


def test_kernel_sources_carry_their_header_note():
    for src in ("edge_head.cu", "slot_stats.cu", "bilateral_tail.cu"):
        text = (PKG / "csrc" / src).read_text()
        head = text[:3000]
        assert "Replaces the TPU kernel" in head and "pdgn_tpu/ops/pallas/" in head
        assert "bounds it on the H100" in head
        assert "simple design" in head
