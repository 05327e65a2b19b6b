"""The entry points of ``--compute_dtype bfloat16`` on the CPU: the test
phase through ``PDGNTrainer.test`` at a tiny size, the CLI's flag checks
(no phase run), and the train phase's refusal."""

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
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(_cli_args(tmp_path, "--phase", phase,
                                 "--d_compute_dtype", "bfloat16"))
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().out


def test_bf16_training_is_refused_by_name(tmp_path, capsys):
    """``--phase train --compute_dtype bfloat16`` exits 2 naming the missing
    backward; the trainer refuses it too rather than train in fp32."""
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(_cli_args(tmp_path, "--phase", "train",
                                 "--compute_dtype", "bfloat16"))
    assert exc.value.code == 2
    assert "backward" in capsys.readouterr().out
    trainer = PDGNTrainer(_config(tmp_path, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="backward"):
        trainer.train(seed=1)
    with pytest.raises(NotImplementedError, match="float32"):
        PDGNTrainer(_config(tmp_path, d_compute_dtype="bfloat16")
                    ).build_model(seed=1)
