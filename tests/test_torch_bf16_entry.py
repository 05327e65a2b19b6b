"""The entry points of ``--compute_dtype bfloat16`` on the CPU: the test
phase through ``PDGNTrainer.test`` at a tiny size and the CLI's flag checks
(no phase run). The train phase in bf16 is tests/test_torch_bf16_train_*.py's."""

import numpy as np
import pytest
import torch

from torch_entry_util import _cli_args

from pdgn_tpu_torch import cli
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer


def _config(tmp_path, **kw):
    return ExperimentConfig(batch_size=4, synthetic_size=4, base_points=16,
                            num_point=256, save_dir=str(tmp_path / "out"),
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            device="cpu", **kw)


def test_bf16_test_phase_gives_finite_metrics(tmp_path):
    """``PDGNTrainer.test`` with compute_dtype bfloat16: the bf16
    generator, fp32 clouds, 13 finite metrics, no kernel launched."""
    trainer = PDGNTrainer(_config(tmp_path, compute_dtype="bfloat16"))
    trainer.build_model(seed=3)
    g = trainer.state.generator
    assert g.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in g.parameters())
    _lib.LAUNCHES.clear()
    res = trainer.test(tile=4)
    assert len(res) == 13 and all(np.isfinite(v) for v in res.values())
    (run,) = (tmp_path / "out").iterdir()
    out = np.load(run / "out.npy")
    assert out.dtype == np.float32 and out.shape == (4, 256, 3)
    assert sum(_lib.LAUNCHES.values()) == 0


@pytest.mark.parametrize("phase", ["sample", "test"])
def test_cli_accepts_bf16_for_sample_and_test(tmp_path, phase):
    args = cli.parse_args(_cli_args(tmp_path, "--phase", phase,
                                    "--compute_dtype", "bfloat16"))
    assert args.compute_dtype == "bfloat16"


@pytest.mark.parametrize("phase", ["sample", "test", "train"])
def test_cli_refuses_bf16_discriminators(tmp_path, phase, capsys):
    """``--d_compute_dtype bfloat16`` is ported: accepted in every phase; a
    dtype with no kernel instance (float16) is refused (exit 2). The name
    is kept from when the port refused bf16 discriminators."""
    args = cli.parse_args(_cli_args(tmp_path, "--phase", phase,
                                    "--d_compute_dtype", "bfloat16"))
    assert args.d_compute_dtype == "bfloat16"
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(_cli_args(tmp_path, "--phase", phase,
                                 "--d_compute_dtype", "float16"))
    assert exc.value.code == 2


def test_bf16_training_is_refused_by_name(tmp_path, capsys):
    """bf16 training is ported: ``--phase train --compute_dtype bfloat16``
    passes the checks, and the trainer builds a bf16 generator with fp32
    discriminators (bf16 ones only with ``d_compute_dtype``) rather than
    refuse or train in fp32. The name is kept from when the port refused
    bf16 training."""
    args = cli.parse_args(_cli_args(tmp_path, "--phase", "train",
                                    "--compute_dtype", "bfloat16"))
    assert args.compute_dtype == "bfloat16" and args.d_compute_dtype is None
    trainer = PDGNTrainer(_config(tmp_path, compute_dtype="bfloat16"))
    trainer.build_model(seed=1)
    assert trainer.state.generator.dtype == torch.bfloat16
    assert all(d.dtype is None for d in trainer.state.discriminators)
    trainer = PDGNTrainer(_config(tmp_path, d_compute_dtype="bfloat16"))
    trainer.build_model(seed=1)
    assert trainer.state.generator.dtype is None
    assert all(d.dtype == torch.bfloat16
               for d in trainer.state.discriminators)
