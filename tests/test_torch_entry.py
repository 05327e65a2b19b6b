"""Entry points of the port on the CPU: the CLI's sample, train and test
phases (synthetic data and a shapenet15k-layout hdf5 file), resuming from
``.pth`` and from the JAX package's ``.msgpack`` bundles, ``--profile_dir``,
``--data_root``, the refused flags, ``python -m pdgn_tpu_torch``, the CUDA
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

import torch_h5_fixture as fx
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


RESULT_LINE = re.compile(
    r"^\[[^\]]+::test::INFO\] ([\w-]+): -?\d+\.\d{12}$")


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


def _train_args(tmp_path, *extra):
    return _cli_args(tmp_path, "--phase", "train", "--dataset", "synthetic",
                     "--batch_size", "4", "--synthetic_size", "8",
                     "--max_epoch", "1", "--max_steps_per_epoch", "2",
                     *extra)


LOG_LINE = re.compile(
    r"^Epoch: \[ *\d+\] \[ *\d+/ *\d+\] time: +\d+m +\d+s "
    r"d_loss1: \d+\.\d{8} d_loss2: \d+\.\d{8} d_loss3: \d+\.\d{8} "
    r"d_loss4: \d+\.\d{8}, g_loss: \d+\.\d{8}, similar_loss: \d+\.\d{8}$")


def test_cli_train_on_cpu_writes_both_bundles_and_the_log(tmp_path):
    _lib.LAUNCHES.clear()
    cli.main(_train_args(tmp_path, "--device", "cpu"))
    run = tmp_path / "ckpt" / "m"
    bundles = run / "PDGNet_v2"
    assert (bundles / "1_full_G.pth").is_file()
    assert (bundles / "1_full_D.pth").is_file()
    lines = (run / "log_info.txt").read_text().splitlines()
    steps = [ln for ln in lines[1:] if ln.startswith("Epoch")]
    assert len(steps) == 2 and all(LOG_LINE.match(ln) for ln in steps), steps
    assert "[   2/   2]" in steps[1]
    g = torch.load(bundles / "1_full_G.pth", weights_only=True)
    d = torch.load(bundles / "1_full_D.pth", weights_only=True)
    assert g["G_epoch"] == 1 and d["D_epoch"] == 1
    assert set(d) == {"D_epoch"} | {f"D_{w}{i}" for w in ("model", "optimizer")
                                    for i in range(1, 5)}
    model = PointGenerator(**SMALL)
    assert load_generator(str(bundles / "1_full_G.pth"), model) == 1
    assert sum(_lib.LAUNCHES.values()) == 0


def test_cli_train_resumes_from_pretrained_bundles(tmp_path, capsys):
    cli.main(_train_args(tmp_path, "--device", "cpu"))
    bundles = tmp_path / "ckpt" / "m" / "PDGNet_v2"
    first = torch.load(bundles / "1_full_G.pth", weights_only=True)
    capsys.readouterr()
    cli.main(_train_args(tmp_path, "--device", "cpu", "--max_epoch", "2",
                         "--pretrain_model_G", "1_full_G.pth",
                         "--pretrain_model_D", "1_full_D.pth"))
    out = capsys.readouterr().out
    assert "Load SUCCESS" in out
    # resumes at the saved epoch and runs through max_epoch: epochs 1 and 2
    assert out.count("Epoch: [ 1]") == 2 and out.count("Epoch: [ 2]") == 2
    second = torch.load(bundles / "2_full_G.pth", weights_only=True)
    assert second["G_epoch"] == 2
    # the Adam state went on from the loaded one: 2 + 4 steps
    steps = {int(v["step"]) for v in second["G_optimizer"]["state"].values()}
    assert steps == {6}
    assert not all(torch.equal(first["G_model"][k], second["G_model"][k])
                   for k in first["G_model"])


SPLITS = {fx.CHAIR: {"train": 8, "val": 2, "test": 6},
          fx.AIRPLANE: {"train": 2, "val": 2, "test": 2}}


@pytest.fixture
def tiny_h5(tmp_path):
    """A shapenet15k-layout file of 256-point clouds (chair: 8 train, 6
    test, the test split chunked through shuffle and deflate)."""
    path = tmp_path / "data" / "shapenet.hdf5"
    path.parent.mkdir()
    fx.write_shapenet(str(path), 4, n_points=256, splits=SPLITS)
    return str(path)


def _h5_args(tmp_path, data, *extra):
    return _cli_args(tmp_path, "--dataset", "shapenet15k", "--data_root",
                     data, "--choice", "chair", "--device", "cpu",
                     "--batch_size", "4", *extra)


def test_cli_train_on_shapenet15k_writes_bundles_and_copies_sources(
        tmp_path, tiny_h5):
    """``--dataset shapenet15k`` trains on the file's chair train split
    (8 clouds, 2 batches of 4), writes both bundles under the category's
    name and copies the generator source beside the log."""
    _lib.LAUNCHES.clear()
    trainer = cli.main(_h5_args(tmp_path, tiny_h5, "--phase", "train",
                                "--max_epoch", "1"))
    run = tmp_path / "ckpt" / "m"
    bundles = run / "PDGNet_v2"
    assert (bundles / "1_chair_G.pth").is_file()
    assert (bundles / "1_chair_D.pth").is_file()
    assert (run / "generator.py").read_text() == (
        PKG / "models" / "generator.py").read_text()
    steps = [ln for ln in (run / "log_info.txt").read_text().splitlines()
             if ln.startswith("Epoch")]
    assert len(steps) == 2 and all(LOG_LINE.match(ln) for ln in steps)
    assert "[   2/   2]" in steps[1]
    assert len(trainer.wait_seconds) == len(trainer.step_seconds) == 2
    assert trainer.cfg.data_root == tiny_h5
    assert sum(_lib.LAUNCHES.values()) == 0


def test_cli_test_phase_scores_the_hdf5_test_split(tmp_path, tiny_h5,
                                                   capsys):
    """``--phase test`` generates as many clouds as the chair test split
    holds (6) and scores them against that split, bbox-normalised (fresh
    weights: no bundle given, so none is loaded)."""
    from pdgn_tpu_torch.data import ShapeNetCore

    tester = cli.main(_h5_args(tmp_path, tiny_h5, "--phase", "test"))
    out = capsys.readouterr().out
    assert " [*] Test finished!" in out
    assert len(tester._make_dataset("test", "shape_bbox")) == 6
    (run,) = (tmp_path / "out").iterdir()
    assert run.name.startswith("GEN_Ours_c_h_a_i_r_")   # "_".join("chair")
    assert np.load(run / "out.npy").shape == (6, 256, 3)
    lines = (run / "log.txt").read_text().splitlines()
    assert len([ln for ln in lines if RESULT_LINE.match(ln)]) == 13
    ref = ShapeNetCore(tiny_h5, "chair", "test", "shape_bbox").full_clouds()
    assert ref.shape == (6, 256, 3)


def test_cli_resumes_from_msgpack_bundles(tmp_path, tiny_h5, capsys):
    """Bundles written as the JAX package's msgpack resume a run: the
    saved epoch, and Adam's state going on (1 + 2 steps: one a epoch)."""
    from pdgn_tpu_torch.train import checkpoint as ckpt_lib

    one = ("--max_steps_per_epoch", "1")
    first = cli.main(_h5_args(tmp_path, tiny_h5, "--phase", "train",
                              "--max_epoch", "1", *one))
    bundles = tmp_path / "ckpt" / "m" / "PDGNet_v2"
    paths = ckpt_lib.save(str(bundles), first.state, 1, "chair",
                          fmt="msgpack")
    assert [pathlib.Path(p).name for p in paths] == ["1_chair_G.msgpack",
                                                     "1_chair_D.msgpack"]
    capsys.readouterr()
    cli.main(_h5_args(tmp_path, tiny_h5, "--phase", "train", "--max_epoch",
                      "2", "--pretrain_model_G", "1_chair_G.msgpack",
                      "--pretrain_model_D", "1_chair_D.msgpack", *one))
    out = capsys.readouterr().out
    assert "Load SUCCESS" in out
    assert out.count("Epoch: [ 1]") == 1 and out.count("Epoch: [ 2]") == 1
    second = torch.load(bundles / "2_chair_G.pth", weights_only=True)
    steps = {int(v["step"]) for v in second["G_optimizer"]["state"].values()}
    assert steps == {3}


def test_cli_unknown_dataset_fails_as_in_jax(tmp_path):
    """An unknown ``--dataset`` raises the JAX trainer's ValueError when
    the train phase asks for its data."""
    from pdgn_tpu.train import ExperimentConfig as JaxConfig
    from pdgn_tpu.train import PDGNTrainer as JaxTrainer

    with pytest.raises(ValueError) as want:
        JaxTrainer(JaxConfig(dataset="shapenet55", base_points=16)
                   )._make_dataset("train", "shape_unit")
    with pytest.raises(ValueError) as got:
        cli.main(_cli_args(tmp_path, "--phase", "train", "--device", "cpu",
                           "--dataset", "shapenet55"))
    assert str(got.value) == str(want.value) == "unknown dataset shapenet55"


def test_data_root_reaches_the_trainer(tmp_path):
    """``--data_root`` is the file the trainer opens."""
    missing = str(tmp_path / "nowhere" / "shapenet.hdf5")
    args = cli.parse_args(_cli_args(tmp_path, "--phase", "train",
                                    "--device", "cpu", "--data_root",
                                    missing))
    assert args.data_root == missing
    with pytest.raises(FileNotFoundError, match="nowhere"):
        cli.main(_cli_args(tmp_path, "--phase", "train", "--device", "cpu",
                           "--dataset", "shapenet15k", "--choice", "chair",
                           "--data_root", missing))


def test_profile_dir_writes_a_trace(tmp_path):
    """``--profile_dir``: a Chrome trace from global step 2 on (three
    steps: the trace ends with the run)."""
    import json

    prof = tmp_path / "prof"
    cli.main(_train_args(tmp_path, "--device", "cpu", "--synthetic_size",
                         "12", "--max_steps_per_epoch", "3", "--profile_dir",
                         str(prof)))
    (trace,) = prof.iterdir()
    assert trace.name.endswith(".json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) > 0


@pytest.mark.parametrize("flag", ["--compute_dtype", "--d_compute_dtype"])
def test_cli_refuses_bf16_compute(tmp_path, flag, capsys):
    assert cli.parse_args(_cli_args(tmp_path, flag, "float32"))
    with pytest.raises(SystemExit) as exc:
        cli.main(_cli_args(tmp_path, "--phase", "train", "--device", "cpu",
                           flag, "bfloat16"))
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().out


def test_cli_accepts_every_flag_of_the_jax_cli():
    flag = re.compile(r"add_argument\(\s*'(--\w+)'")
    jax_flags = set(flag.findall((ROOT / "pdgn_tpu" / "cli.py").read_text()))
    ours = set(flag.findall((PKG / "cli.py").read_text()))
    assert len(jax_flags) > 30 and jax_flags <= ours, jax_flags - ours


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


def test_cli_train_default_device_fails_loudly_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_train_args(tmp_path))
    assert not (tmp_path / "ckpt" / "m" / "PDGNet_v2").exists()


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
    """Every module of the port imports without pulling in JAX, flax, the
    JAX package, h5py or msgpack (the card's machine has neither)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pdgn_tpu', 'h5py', 'msgpack')]\n"
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
    for src in ("edge_head.cu", "slot_stats.cu", "bilateral_tail.cu",
                "edge_head_bwd.cu", "bilateral_tail_bwd.cu",
                "local_stats.cu", "emd_cd.cu", "knn.cu"):
        text = (PKG / "csrc" / src).read_text()
        head = text[:3000]
        assert "Replaces the TPU kernel" in head and "pdgn_tpu/ops/pallas/" in head
        assert "bounds it on the H100" in head
        assert re.search(r"The (simple )?design", head)
