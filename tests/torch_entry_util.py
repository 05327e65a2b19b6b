"""Shared arguments, patterns and fixtures of the port's entry-point tests
(``tests/test_torch_entry_*.py``)."""

import pathlib
import re

import pytest
import torch

import torch_h5_fixture as fx

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pdgn_tpu_torch"
SMALL = dict(base_points=16)


def _cli_args(tmp_path, *extra):
    return ["--network", "PDGNet_v2", "--model_dir", "m",
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--save_dir", str(tmp_path / "out"), "--base_points", "16",
            "--num_samples", "5", "--batch_size", "2", *extra]


RESULT_LINE = re.compile(
    r"^\[[^\]]+::test::INFO\] ([\w-]+): -?\d+\.\d{12}$")


def _train_args(tmp_path, *extra):
    return _cli_args(tmp_path, "--phase", "train", "--dataset", "synthetic",
                     "--batch_size", "4", "--synthetic_size", "8",
                     "--max_epoch", "1", "--max_steps_per_epoch", "2",
                     *extra)


LOG_LINE = re.compile(
    r"^Epoch: \[ *\d+\] \[ *\d+/ *\d+\] time: +\d+m +\d+s "
    r"d_loss1: \d+\.\d{8} d_loss2: \d+\.\d{8} d_loss3: \d+\.\d{8} "
    r"d_loss4: \d+\.\d{8}, g_loss: \d+\.\d{8}, similar_loss: \d+\.\d{8}$")


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
