"""Batch statistics over uneven shards on a 2-rank gloo group, and the
row-distributed generation and evaluation.

* The port's synced functional ``batch_norm`` on shards of 3 + 2 rows
  against ``pdgn_tpu.parallel.batch_norm`` on the concatenation (rel <=
  1e-5), its input gradient against one process's on the concatenation
  (rel <= 1e-5), and ``per_replica_batch_norm`` against JAX's on each
  shard; the two modes differ.
* A train step at B=3 (2 + 1 rows: the JAX package pads this batch and
  masks it, the port gives the ranks uneven rows) at key 38, from the
  weights that ``generator_state_from_jax`` / ``discriminator_state_from_
  jax`` carry across, the clouds and the JAX step's noise, held against
  the jitted JAX step on the unpadded batch run in float64
  (``torch_parallel_ref.float64_scope``: its jaxpr holds no float32
  value) from the same state, clouds and noise. The two ranks' float64
  step equals it within 1e-9 everywhere (measured: metrics 1.4e-13, the
  generator's gradient 2.1e-12 of its largest, running statistics
  1.8e-11) and equals the port's one-process float64 step (4.1e-13,
  1.1e-11, 4.9e-11): the global statistics, counts and gradient sums over
  uneven shards are exact.
* In float32 the step at B=3 turns on near-ties of the kNN graphs, in
  JAX as in the port. Inside JAX's jitted float32 step the D noise's
  forward swaps 4 stage-4 entries against the float64 graphs (largest
  relative distance gap 3.6e-6) and the G noise's swaps 2 stage-3
  entries (2.7e-5), which puts JAX's float32 step 6.1e-3 (metrics),
  3.0e-3 (D gradients) and 6.1e-3 (statistics) off its own float64 step,
  beyond the limits of ``tests/test_torch_train_step.py``. The two ranks'
  float32 forward, whose sums add in another order, swaps the same 4
  stage-4 entries of the D noise's (3.6e-6) and 3 stage-4 entries of the
  G noise's (3.9e-5). So the two ranks' float32 step is held to JAX's
  float64 step at JAX's limits on what those swaps leave within them, the
  metrics (6.0e-5 against 1e-4) and the running statistics (5.9e-4
  against 1e-3), and to JAX's float32 step on the four discriminator
  losses (1.1e-5 against 1e-4); its D and G gradients (3.0e-3, and 0.0995
  of G's largest with relative L2 0.12) are held in float64 above. The
  ranks end with equal parameters and Adam states. Measured by ``python
  tests/torch_parallel_ref.py --batch 3 --key 38``.
* ``pairwise_cd_emd(mesh=...)`` on 13 x 9 clouds at tile 2 (ragged tiles,
  as ``tests/test_parallel.py:260``) equals the one-process matrices.
* ``generate()`` over the ranks returns the one-process clouds in order.
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as workers
from torch_parallel_ref import (JAX_LIMITS, NETS, gaps, jax_reference,
                                jax_step, jax_steps, port_reference,
                                port_step, rank_args, within)
from torch_port_util import one_torch_thread, rel  # noqa: F401

import jax.numpy as jnp
from pdgn_tpu.parallel import batch_norm as jax_batch_norm
from pdgn_tpu_torch.eval.metrics import pairwise_cd_emd
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.parallel import DataAxis, local_batch_slice, shard_rows
from pdgn_tpu_torch.train.generate import generate
from pdgn_tpu_torch.train.train_step import METRICS

B = 3
# The step's key at B=3: for keys 26..39, key 28 (B=4's) has the port's
# second generator forward build 95 graph entries otherwise than the jitted
# JAX forward (7 in float64); keys 32 and 38 have both forwards build JAX's
# graphs in float32 and float64 (stand-alone jitted forwards; inside its
# step JAX's float32 graphs differ at near-ties, see above). The float64
# checks hold at any key; the float32 ones need a key whose float32 graphs
# the port builds as in float64. At key 26 the port's one-process float32
# forwards swap 2 and 10 stage-4 entries of the float64 graphs (gaps from
# 4.9e-7), and its float32 step is 1.34e-3 off JAX's float64 metrics (two
# ranks 5.8e-4, against 1e-4), JAX's own float32 step 5.7e-2 (measured as
# above, ``--key 26``).
KEY = 38
EXACT = dict(metrics=1e-9, d=1e-9, g=1e-9, g_l2=1e-9, stats=1e-9)
# the float32 step against JAX's float64 step: the quantities that the
# float32 graphs' near-ties leave within JAX's limits (see the docstring)
F32_HELD = {k: JAX_LIMITS[k] for k in ("metrics", "stats")}
GEN = dict(n=7, batch_size=2, seed=5)       # 4 batches, the last one ragged


def _bn_case():
    rs = np.random.RandomState(3)
    x = (rs.randn(5, 10, 4) + np.arange(5)[:, None, None]).astype(np.float32)
    return dict(x=x, scale=(rs.rand(4) + 0.5).astype(np.float32),
                bias=rs.randn(4).astype(np.float32),
                ct=rs.randn(5, 10, 4).astype(np.float32))


def _eval_case():
    rs = np.random.RandomState(0)
    return dict(sample=rs.randn(13, 32, 3).astype(np.float32),
                ref=rs.randn(9, 32, 3).astype(np.float32), tile=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = jax_step(B, KEY, step=False)
    args = rank_args(inputs)
    tasks = [("bn", _bn_case()), ("pairwise", _eval_case()),
             ("generate", dict(g_state=inputs["g_state"], **GEN)),
             ("step", args), ("step64", args)]
    tmp = tmp_path_factory.mktemp("parallel_bn")
    ranks = workers.start(tmp, 2, tasks)
    ref, ref64 = jax_steps(B, KEY)
    single64 = port_step(ref64, torch.float64)
    out = workers.finish(ranks, tmp, tasks)
    out.update(ref=ref, ref64=ref64, single64=single64)
    return out


def test_synced_batch_norm_equals_jax_on_the_concatenation(runs):
    case = _bn_case()
    want = np.asarray(jax_batch_norm(jnp.asarray(case["x"]),
                                     jnp.asarray(case["scale"]),
                                     jnp.asarray(case["bias"])))
    got = torch.cat([r["y"] for r in runs["bn"]])
    assert [r["y"].shape[0] for r in runs["bn"]] == [3, 2]
    assert rel(got, want) <= 1e-5


def test_synced_batch_norm_gradient_equals_one_process(runs):
    from pdgn_tpu_torch.parallel import batch_norm

    case = _bn_case()
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = batch_norm(x, torch.from_numpy(case["scale"]),
                   torch.from_numpy(case["bias"]))
    (y * torch.from_numpy(case["ct"])).sum().backward()
    got = torch.cat([r["dx"] for r in runs["bn"]])
    assert rel(got, x.grad) <= 1e-5


def test_per_replica_batch_norm_is_each_shards_own(runs):
    case = _bn_case()
    for rows, r in zip((slice(0, 3), slice(3, 5)), runs["bn"]):
        want = np.asarray(jax_batch_norm(jnp.asarray(case["x"][rows]),
                                         jnp.asarray(case["scale"]),
                                         jnp.asarray(case["bias"])))
        assert rel(r["local"], want) <= 1e-5
        assert not np.allclose(r["local"].numpy(), r["y"].numpy(),
                               atol=1e-3)


def test_uneven_step_counts_the_global_batch(runs):
    for out in runs["step"] + runs["step64"]:
        assert out["step"] == 1 and torch.isfinite(out["metrics"]).all()
        for net in NETS:
            assert torch.isfinite(out[net]["grad"]).all(), net
            assert out[net]["state"][next(
                k for k in out[net]["state"]
                if k.endswith("num_batches_tracked"))] >= 1


def test_uneven_float64_step_equals_jax_float64(runs):
    out = runs["step64"][0]
    res = gaps(out, *jax_reference(runs["ref64"], out))
    assert within(res, EXACT), res


def test_uneven_float64_step_equals_one_process(runs):
    res = gaps(runs["step64"][0], *port_reference(runs["single64"]))
    assert within(res, EXACT), res


def test_uneven_step_discriminator_losses_match_jax(runs):
    got = runs["step"][0]["metrics"][:4].double().numpy()
    want = np.array([runs["ref"]["metrics"][k] for k in METRICS[:4]])
    assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-4


def test_uneven_float32_metrics_and_statistics_within_jax_limits(runs):
    out = runs["step"][0]
    res = gaps(out, *jax_reference(runs["ref64"], out))
    assert within(res, F32_HELD), res


def test_uneven_ranks_hold_equal_state(runs):
    for r0, r1 in (runs["step"], runs["step64"]):
        assert torch.equal(r0["metrics"], r1["metrics"])
        for net in NETS:
            for key in ("exp_avg", "grad", "params"):
                assert torch.equal(r0[net][key], r1[net][key]), (net, key)
            for key, v in r0[net]["state"].items():
                assert torch.equal(v, r1[net]["state"][key]), (net, key)


def test_pairwise_rows_over_ranks_equal_one_process(runs):
    case = _eval_case()
    cd1, emd1 = pairwise_cd_emd(case["sample"], case["ref"], tile=2,
                                device="cpu")
    for cd2, emd2 in runs["pairwise"]:
        assert cd2.shape == emd2.shape == (13, 9)
        np.testing.assert_allclose(cd2, cd1, atol=1e-5)
        np.testing.assert_allclose(emd2, emd1, rtol=1e-4)


def test_generate_over_ranks_gives_the_one_process_clouds(runs):
    G = PointGenerator(num_point=workers.SIZES[-1],
                       base_points=workers.BASE)
    G.load_state_dict(runs["ref"]["g_state"])
    want = torch.from_numpy(generate(device="cpu", model=G, **GEN))
    assert want.shape == (GEN["n"], workers.SIZES[-1], 3)
    for got in runs["generate"]:
        assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("batch, world, sizes", [
    (4, 2, [2, 2]), (3, 2, [2, 1]), (35, 4, [9, 9, 9, 8]),
    (5, 3, [2, 2, 1])])
def test_shard_rows_cover_the_batch_in_rank_order(batch, world, sizes):
    rows = [shard_rows(batch, r, world) for r in range(world)]
    assert [s.stop - s.start for s in rows] == sizes
    assert rows[0].start == 0 and rows[-1].stop == batch
    assert all(a.stop == b.start for a, b in zip(rows, rows[1:]))


def test_more_ranks_than_rows_is_refused():
    with pytest.raises(ValueError, match="smaller than"):
        shard_rows(1, 0, 2)


def test_no_group_keeps_every_row():
    assert local_batch_slice(6) == slice(0, 6)


def test_axis_refuses_rows_the_batch_does_not_give_it():
    axis = DataAxis.__new__(DataAxis)
    axis.group, axis.rank, axis.world = None, 1, 2
    axis.rows = axis.batch = None
    with pytest.raises(ValueError, match="holds 2 rows"):
        axis.begin(2, 3)
    with pytest.raises(ValueError, match="global batch"):
        axis.begin(1, None)
    axis.begin(1, 3)
    assert axis.count(1 * 64) == 3 * 64


def test_no_environment_makes_no_group(monkeypatch):
    import torch.distributed as dist

    from pdgn_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv("TORCHELASTIC_RUN_ID", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert initialize_distributed(device="cpu") == 1
    assert not dist.is_initialized()


def test_failed_initialisation_raises(monkeypatch):
    from pdgn_tpu_torch.parallel import initialize_distributed

    monkeypatch.setenv("TORCHELASTIC_RUN_ID", "test")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize_distributed(device="cpu", timeout_s=10)


def test_cli_trains_on_two_ranks_through_torchrun(tmp_path):
    """``torchrun --nproc_per_node=2 -m pdgn_tpu_torch --device cpu``: one
    seed on both ranks, rank 0 alone logs and writes the bundles."""
    import os
    import pathlib
    import re
    import socket
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "TORCHELASTIC_RUN_ID")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc_per_node=2", f"--master_port={port}", "--tee=3", "-m",
         "pdgn_tpu_torch", "--network", "PDGNet_v2", "--phase", "train",
         "--dataset", "synthetic", "--device", "cpu", "--base_points", "16",
         "--num_point", "256", "--batch_size", "3", "--synthetic_size", "6",
         "--max_epoch", "1", "--max_steps_per_epoch", "2",
         "--model_dir", "m", "--checkpoint_dir", str(tmp_path / "ckpt")],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=workers.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # --tee: each rank's lines whole, prefixed with its local rank
    seeds = dict(re.findall(r"^\[\w*?(\d)\]:Random Seed:\s+(\d+)$",
                            proc.stdout, re.M))
    assert len(seeds) == 2 and seeds["0"] == seeds["1"], proc.stdout
    assert len(re.findall(r"^\[\w*?0\]:Epoch: ", proc.stdout, re.M)) == 2
    assert not re.findall(r"^\[\w*?1\]:Epoch: ", proc.stdout, re.M)
    run = tmp_path / "ckpt" / "m"
    assert (run / "PDGNet_v2" / "1_full_G.pth").is_file()
    assert (run / "PDGNet_v2" / "1_full_D.pth").is_file()
    assert len((run / "log_info.txt").read_text().splitlines()) == 3
