"""The port's CLI train phase on the CPU on synthetic data: both bundles
and the log, ``--profile_dir``, ``--data_root``, an unknown dataset, and
the CUDA default that fails loudly without a card."""

import pytest
import torch

from torch_entry_util import LOG_LINE, SMALL, _cli_args, _train_args

from pdgn_tpu_torch import cli
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.train.checkpoint import load_generator


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


def test_cli_train_default_device_fails_loudly_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_train_args(tmp_path))
    assert not (tmp_path / "ckpt" / "m" / "PDGNet_v2").exists()
