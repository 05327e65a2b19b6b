"""The port's test phase as a whole on the CPU (sampling, renormalisation,
the npy dumps, the metric suite, the log lines), held against the JAX
package's suite on the port's own output clouds; ``normalize_point_clouds``
and ``SyntheticShapes.full_clouds`` against their JAX counterparts."""

import os
import re

import numpy as np
import pytest
import torch

from pdgn_tpu.data.shapenet import SyntheticShapes as JSyntheticShapes
from pdgn_tpu.eval import compute_all_metrics, jsd_between_point_cloud_sets
from pdgn_tpu.train.trainer import (
    normalize_point_clouds as j_normalize_point_clouds)
from pdgn_tpu_torch.data.shapenet import SyntheticShapes
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.train import checkpoint as ckpt_lib
from pdgn_tpu_torch.train.generate import generate
from pdgn_tpu_torch.train.trainer import (ExperimentConfig, PDGNTrainer,
                                          normalize_point_clouds)

KEYS = ("lgan_mmd-CD", "lgan_cov-CD", "lgan_mmd_smp-CD", "lgan_mmd-EMD",
        "lgan_cov-EMD", "lgan_mmd_smp-EMD", "1-NN-CD-acc_t", "1-NN-CD-acc_f",
        "1-NN-CD-acc", "1-NN-EMD-acc_t", "1-NN-EMD-acc_f", "1-NN-EMD-acc",
        "jsd")
EXACT = tuple(k for k in KEYS if "cov" in k or "1-NN" in k)
RESULT_LINE = re.compile(r"\] ([\w-]+): (-?\d+\.\d{12})$")


@pytest.mark.parametrize("mode", ["shape_unit", "shape_bbox", None])
def test_normalize_point_clouds_matches_jax(mode):
    pcs = (np.random.RandomState(1).randn(4, 50, 3) * 0.3 + 0.1).astype(
        np.float32)
    got = normalize_point_clouds(pcs, mode)
    want = j_normalize_point_clouds(pcs, mode)
    np.testing.assert_array_equal(got, want)
    if mode is not None:
        assert got is not pcs and not np.array_equal(got, pcs)
    with pytest.raises(ValueError):
        normalize_point_clouds(pcs, "shape_half")


def test_full_clouds_match_jax():
    got = SyntheticShapes(size=5, num_points=64).full_clouds()
    want = JSyntheticShapes(size=5, num_points=64).full_clouds()
    assert got.shape == (5, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _cfg(tmp_path, **kw):
    base = dict(base_points=16, synthetic_size=6, batch_size=3, device="cpu",
                save_dir=str(tmp_path / "results"),
                checkpoint_dir=str(tmp_path / "ckpt"), model_dir="m")
    base.update(kw)
    return ExperimentConfig(**base)


@pytest.fixture(scope="module")
def test_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("test_phase")
    trainer = PDGNTrainer(_cfg(tmp))
    trainer.build_model(seed=5)
    _lib.LAUNCHES.clear()
    results = trainer.test(tile=3)
    runs = os.listdir(tmp / "results")
    assert len(runs) == 1 and runs[0].startswith("GEN_Ours_full_")
    return trainer, results, tmp / "results" / runs[0]


def test_test_phase_writes_the_dumps_and_the_key_set(test_run):
    trainer, results, run = test_run
    assert tuple(results) == KEYS
    assert all(np.isfinite(v) for v in results.values())
    raw = np.load(run / "nonormal_out.npy")
    out = np.load(run / "out.npy")
    assert raw.shape == out.shape == (6, 256, 3)
    # the raw dump is the sampler's output for the phase's seed ...
    want = generate(6, 3, 9999, device="cpu", model=trainer.state.generator)
    np.testing.assert_array_equal(raw, want)
    # ... and out.npy its shape_bbox renormalisation
    np.testing.assert_array_equal(out, normalize_point_clouds(raw,
                                                              "shape_bbox"))
    assert sum(_lib.LAUNCHES.values()) == 0


def test_test_phase_matches_the_jax_suite_on_its_clouds(test_run):
    """JAX's compute_all_metrics and JSD on the port's out.npy and the
    reference clouds agree with the port's results and with its log."""
    _, results, run = test_run
    gen = np.load(run / "out.npy")
    ref = SyntheticShapes(size=6, num_points=256).full_clouds()
    want = compute_all_metrics(gen, ref, 3, tile=3)
    want["jsd"] = jsd_between_point_cloud_sets(gen, ref)
    logged = {}
    for line in (run / "log.txt").read_text().splitlines():
        m = RESULT_LINE.search(line)
        if m:
            logged[m.group(1)] = float(m.group(2))
    assert tuple(logged) == KEYS
    for k in KEYS:
        assert abs(logged[k] - results[k]) <= 5e-13
        if k in EXACT:
            assert results[k] == want[k], (k, results[k], want[k])
        else:
            assert abs(results[k] - want[k]) <= 1e-4 * abs(want[k]), k


def test_test_phase_loads_the_bundles(tmp_path, capsys):
    trained = PDGNTrainer(_cfg(tmp_path))
    trained.build_model(seed=7)
    ckpt_lib.save(trained.ckpt_dir, trained.state, 3, "full")
    trainer = PDGNTrainer(_cfg(tmp_path, pretrain_model_G="3_full_G.pth",
                               pretrain_model_D="3_full_D.pth",
                               synthetic_size=3, normalize=None))
    trainer.build_model(seed=8)
    res = trainer.test(tile=2)
    assert " [*] Load SUCCESS" in capsys.readouterr().out
    sg = trained.state.generator.state_dict()
    assert all(torch.equal(v, sg[k]) for k, v in
               trainer.state.generator.state_dict().items())
    run = tmp_path / "results" / os.listdir(tmp_path / "results")[0]
    # normalize=None: out.npy is the raw sample
    np.testing.assert_array_equal(np.load(run / "out.npy"),
                                  np.load(run / "nonormal_out.npy"))
    assert set(res) == set(KEYS)


def test_test_phase_goes_on_without_a_checkpoint(tmp_path, capsys):
    trainer = PDGNTrainer(_cfg(tmp_path, pretrain_model_G="none_G.pth",
                               pretrain_model_D="none_D.pth",
                               synthetic_size=2))
    trainer.build_model(seed=9)
    trainer.test(tile=2)
    assert " [!] Load failed... (no checkpoint found" in \
        capsys.readouterr().out
