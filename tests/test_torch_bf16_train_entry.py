"""The train phase's entry points with ``--compute_dtype bfloat16`` and
``--d_compute_dtype bfloat16`` on the CPU, in process (no CLI subprocess):
the CLI's flag checks, ``PDGNTrainer.train`` taking one finite bf16 step
at a tiny size, and its bundles loading into the fp32 port and, written
as msgpack, into the JAX package's checkpoint loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_entry_util import _cli_args
from torch_port_util import one_torch_thread  # noqa: F401

from pdgn_tpu.convert_ckpt import convert_discriminator, convert_generator
from pdgn_tpu.train import TrainConfig as JaxTrainConfig
from pdgn_tpu.train import checkpoint as jckpt
from pdgn_tpu.train.train_step import GANState, NetState, make_optimizer
from pdgn_tpu_torch import cli
from pdgn_tpu_torch.models.discriminator import discriminators
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.train import checkpoint as tckpt
from pdgn_tpu_torch.train.train_step import TrainConfig, init_state
from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

BF = torch.bfloat16


@pytest.mark.parametrize("phase", ["train", "test", "sample"])
def test_cli_accepts_both_bf16_flags(tmp_path, phase):
    args = cli.parse_args(_cli_args(tmp_path, "--phase", phase,
                                    "--compute_dtype", "bfloat16",
                                    "--d_compute_dtype", "bfloat16"))
    assert args.compute_dtype == args.d_compute_dtype == "bfloat16"


def _config(tmp_path, **kw):
    return ExperimentConfig(batch_size=4, synthetic_size=4, base_points=16,
                            num_point=256, max_epoch=1,
                            save_dir=str(tmp_path / "out"),
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            device="cpu", **kw)


def _fp32_state():
    G = PointGenerator(num_point=256, base_points=16)
    return init_state(G, list(discriminators()), TrainConfig())


def test_bf16_train_phase_steps_and_saves_loadable_bundles(tmp_path):
    """One bf16 step through ``PDGNTrainer.train`` (plain versions, no
    launch); its ``.pth`` bundles load into the fp32 port bit for bit, and
    the same state written as msgpack restores in ``pdgn_tpu.train.
    checkpoint.load`` into the JAX package's state tree."""
    trainer = PDGNTrainer(_config(tmp_path, compute_dtype="bfloat16"))
    trainer.build_model(seed=2)
    g = trainer.state.generator
    assert g.dtype == BF
    assert all(d.dtype is None for d in trainer.state.discriminators)
    _lib.LAUNCHES.clear()
    trainer.train(seed=3)
    assert sum(_lib.LAUNCHES.values()) == 0
    assert trainer.state.step == 1
    assert len(trainer.last_metrics) == 6
    assert all(np.isfinite(v) for v in trainer.last_metrics.values())
    assert all(p.dtype == torch.float32 for p in g.parameters())

    paths = [str(p) for p in sorted((tmp_path / "ckpt").rglob("1_full_*.pth"))]
    assert [p.rsplit("_", 1)[1] for p in paths] == ["D.pth", "G.pth"]
    fp32 = _fp32_state()
    assert tckpt.load(paths[1], paths[0], fp32) == 1
    for src, dst in zip((g,) + trainer.state.discriminators,
                        (fp32.generator,) + fp32.discriminators):
        for (name, a), b in zip(src.state_dict().items(),
                                dst.state_dict().values()):
            assert torch.equal(a, b), name

    mp = tckpt.save(str(tmp_path / "mp"), fp32, 1, "full", fmt="msgpack")
    init = jax.jit(make_optimizer(JaxTrainConfig()).init)

    def net(sd, convert):
        v, _ = convert({k: x.numpy().copy() for k, x in sd.items()})
        v = jax.tree.map(jnp.asarray, v)
        return NetState(v["params"], v["batch_stats"], init(v["params"]))

    template = GANState(
        g=net(PointGenerator(base_points=16).state_dict(), convert_generator),
        d=tuple(net(d.state_dict(), convert_discriminator)
                for d in discriminators()),
        step=jnp.zeros((), jnp.int32))
    restored, epoch = jckpt.load(*mp, template)
    assert epoch == 1
    want, _ = convert_generator({k: x.numpy()
                                 for k, x in g.state_dict().items()})
    got = jax.tree.map(np.asarray, restored.g.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want["params"])):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    mu = jax.tree.leaves(restored.g.opt_state[0].mu)
    assert any(np.abs(np.asarray(m)).max() > 0 for m in mu)


def test_bf16_discriminators_are_built_on_request(tmp_path):
    """``d_compute_dtype="bfloat16"`` builds bf16 discriminators; the
    default keeps them fp32 under ``compute_dtype="bfloat16"``."""
    trainer = PDGNTrainer(_config(tmp_path, compute_dtype="bfloat16",
                                  d_compute_dtype="bfloat16"))
    trainer.build_model(seed=4)
    assert trainer.state.generator.dtype == BF
    assert all(d.dtype == BF for d in trainer.state.discriminators)
    assert all(p.dtype == torch.float32
               for d in trainer.state.discriminators
               for p in d.parameters())
