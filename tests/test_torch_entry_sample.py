"""The port's sample and test phases on the CPU: the CLI's sample, test and
dead ``cls`` phases, the CUDA default that fails loudly without a card, the
refused fast graphs, ``python -m pdgn_tpu_torch``, the sampler's frozen
running statistics and batch statistics, and reference-format
checkpoints."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_entry_util import (RESULT_LINE, ROOT, SMALL, _cli_args,
                              _save_reference_format)
from torch_port_util import rel

from pdgn_tpu_torch import cli
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.train.checkpoint import load_generator
from pdgn_tpu_torch.train.generate import build_generator, generate
from pdgn_tpu_torch.train.sampler import make_sampler


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


@pytest.mark.parametrize("phase", ["test", "cls"])
def test_cli_unported_phases_exit_nonzero(tmp_path, phase, capsys):
    """``--phase test`` runs on the CPU: the dumps and the reference's
    result lines (``"%s: %.12f"``) in the run's log; ``cls`` is the
    reference's dead phase: its message, and exit 1 as ``pdgn_tpu.cli``."""
    args = _cli_args(tmp_path, "--phase", phase, "--device", "cpu",
                     "--dataset", "synthetic", "--synthetic_size", "4")
    if phase != "test":
        with pytest.raises(SystemExit) as exc:
            cli.main(args)
        assert exc.value.code == 1
        assert "dead phase" in capsys.readouterr().out
        return
    _lib.LAUNCHES.clear()
    cli.main(args)
    assert " [*] Test finished!" in capsys.readouterr().out
    (run,) = (tmp_path / "out").iterdir()
    assert run.name.startswith("GEN_Ours_full_")
    assert np.load(run / "nonormal_out.npy").shape == (4, 256, 3)
    assert np.load(run / "out.npy").shape == (4, 256, 3)
    lines = (run / "log.txt").read_text().splitlines()
    keys = [m.group(1) for m in map(RESULT_LINE.match, lines) if m]
    assert keys == ["lgan_mmd-CD", "lgan_cov-CD", "lgan_mmd_smp-CD",
                    "lgan_mmd-EMD", "lgan_cov-EMD", "lgan_mmd_smp-EMD",
                    "1-NN-CD-acc_t", "1-NN-CD-acc_f", "1-NN-CD-acc",
                    "1-NN-EMD-acc_t", "1-NN-EMD-acc_f", "1-NN-EMD-acc", "jsd"]
    assert sum(_lib.LAUNCHES.values()) == 0


def test_cli_test_default_device_fails_loudly_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_cli_args(tmp_path, "--phase", "test", "--dataset",
                           "synthetic"))
    assert not (tmp_path / "out").exists()


def test_cli_refuses_fast_knn_graphs(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_cli_args(tmp_path, "--phase", "test", "--device", "cpu",
                           "--dataset", "synthetic", "--exact_knn", "0"))
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().out


def test_module_entry_point_runs(tmp_path):
    """``python -m pdgn_tpu_torch``, ``main.py``'s counterpart."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "pdgn_tpu_torch", *_cli_args(
            tmp_path, "--phase", "sample", "--device", "cpu",
            "--num_samples", "2")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert " [*] Sampling finished!" in res.stdout
    assert np.load(tmp_path / "out" / "samples_m_2.npy").shape == (2, 256, 3)


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
