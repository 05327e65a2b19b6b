"""The port's CLI on a shapenet15k-layout hdf5 file on the CPU: the train
phase on the chair train split, the test phase on its test split, and a
resume from the JAX package's ``.msgpack`` bundles."""

import pathlib

import numpy as np
import torch

from torch_entry_util import (LOG_LINE, PKG, RESULT_LINE, _h5_args,
                              tiny_h5)  # noqa: F401 (a fixture)
from torch_port_util import one_torch_thread  # noqa: F401

from pdgn_tpu_torch import cli
from pdgn_tpu_torch.ops.kernels import _lib


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
