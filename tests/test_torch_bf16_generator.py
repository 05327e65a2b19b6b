"""The port's generator under ``--compute_dtype bfloat16`` (its CPU path:
the bf16 instances' plain versions) against the JAX package's generator
with ``dtype="bfloat16"``, on the same weights (the port's, carried to JAX
by ``pdgn_tpu.convert_ckpt.convert_generator``) and the same numpy noise;
and against the port's own fp32 generator.

JAX runs in its fp32-exact kNN regime (``exact_knn_scope(True)``) with the
port's graph of each stage injected (``pdgn_tpu.ops.edges._neighbor_idx``
patched here): its own exact graph of bf16 features rounds the row norms
to bf16 (pdgn_tpu/ops/pairwise.py:54), which is the reference's rounding,
not the port's (tests/test_torch_bf16_kernels.py holds the port's graph to
float64's). JAX is jitted with XLA's excess precision off: by default XLA
drops a bf16 rounding whose consumer upcasts again inside a fusion (the
JAX package pins its stage boundaries against that, generator.py:174-183,
but not the global branches), and its jitted global branch then differs
from its own eager one in 50-62% of the entries; with the option off it
keeps every rounding of the source, as its eager path and the port do.

Small configuration: base_points 16, B=4, num_k 20, seeded weights with
random batch-norm parameters. Tolerances, measured here:

* each stage fed identical bf16 inputs: stage 1 bit-equal; g of every
  stage bit-equal, xs but 0.39% of stage 2's entries (rel 2.0e-7); ec of
  stages 2-4 differs in 0.21% / 0.61% / 0.37% of the entries, rel 4.2e-3
  / 3.5e-3 / 3.3e-3 of its largest. The two sides take the batch norms'
  sums and the second-moment identity's bn_all2 statistics in other fp32
  orders, so a value at a bf16 midpoint (a slot weight, a gate, a stored
  activation) rounds the other way, and a batch norm whose mean lies many
  standard deviations from 0 turns that ulp into several of its small
  outputs. Limits: rel 1e-2, at most 1.5% of the entries.
* the whole small generator: those differences cross the stages and the
  global branches' batch norms over B=4 rows: clouds rel 4.3e-3, 4.6e-3,
  3.4e-2, 4.1e-2 (stage 1..4). Limits rel 1e-2 (cloud 1), 6e-2.
* bf16 against fp32 (B=16, same weights and noise): the mean matched
  Chamfer distance of the port's bf16 clouds to its fp32 clouds is
  1.50e-3, against 1.94e-3 between fp32 clouds from other noise (the
  sampling gap): 0.77 of it. That is the bf16 policy's own effect at
  random weights: the JAX package's bf16 clouds lie 1.35e-3 from its fp32
  clouds (0.69). Limits: the port's gap at most 1.25x the JAX package's,
  and under the sampling gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import bf16_pair, rel, t

import pdgn_tpu.models.generator as jgen
import pdgn_tpu.ops.edges as jedges
from pdgn_tpu.convert_ckpt import convert_generator
from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu_torch.models.generator import PointGenerator

BASE = 16
B = 4


def _perturbed_state(seed):
    """A seeded port generator's weights with random batch-norm parameters
    and running statistics (identity init would hide channel-order
    mistakes)."""
    model = PointGenerator(base_points=BASE)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for key, v in sd.items():
        if key.endswith((".weight", ".running_var")) and v.dim() == 1:
            sd[key] = t((1.0 + 0.2 * rng.randn(v.numel())).astype(np.float32))
        elif key.endswith((".bias", ".running_mean")) and v.dim() == 1:
            sd[key] = t((0.2 * rng.randn(v.numel())).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def weights():
    """JAX variables converted from the port's weights (``convert_generator``,
    no flax init: its bf16 eager trace takes a minute on the CPU), the JAX
    bf16 generator and the port's bf16 one."""
    state = _perturbed_state(0)
    v, _ = convert_generator({k: x.numpy() for k, x in state.items()})
    v = jax.tree.map(jnp.asarray, v)
    gen = jgen.PointGenerator(num_k=20, base_points=BASE, dtype="bfloat16")
    model = PointGenerator(base_points=BASE, dtype=torch.bfloat16)
    model.load_state_dict(state)
    return gen, v["params"], v["batch_stats"], model, state


class _Graphs:
    """``_neighbor_idx`` for the JAX package that hands out the port's
    graphs in stage order (read when the JAX forward is traced)."""

    def __init__(self, graphs):
        self.queue = [np.asarray(g) for g in graphs]

    def __call__(self, x, k):
        g = self.queue.pop(0)
        assert g.shape == (x.shape[0], x.shape[1], k)
        return jnp.asarray(g)


def _stage_inputs(stage):
    fin = 32 * 2 ** (stage - 1)
    n = BASE * 2 ** (stage - 1)
    rng = np.random.RandomState(50 + stage)
    if stage == 1:
        return [bf16_pair(rng.randn(B, n, fin))], {}
    return ([bf16_pair(rng.randn(B, n, fin // 2)),
             bf16_pair(rng.randn(B, n, 3) * 0.3)],
            {"xs_in": bf16_pair(rng.randn(B, fin // 2))})


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_bf16_stage_matches_jax(weights, stage, monkeypatch):
    """Each BilateralBlock fed identical bf16 inputs, the port's graph
    injected into JAX: ec, xs and g rel <= 1e-2, at most 1.5% of the
    entries differing (module docstring)."""
    _, params, stats, model, _ = weights
    fin = 32 * 2 ** (stage - 1)
    name = f"bilateral{stage}"
    args, kw = _stage_inputs(stage)
    block = getattr(model, name)
    block.train()
    with torch.no_grad():
        xs_g, g_g, ec_g, idx = block(*(a[0] for a in args),
                                     **{k: v[0] for k, v in kw.items()})
    monkeypatch.setattr(jedges, "_neighbor_idx", _Graphs([idx]))
    mod = jgen.BilateralBlock(fin, fin, 10, bilateral=stage > 1,
                              with_g=stage < 4, dtype="bfloat16", name=name)
    variables = {"params": params[name], "batch_stats": stats[name]}
    with exact_knn_scope(True):
        xs_w, g_w, ec_w = _compiled(
            lambda v, *a, **k: mod.apply(v, *a, mutable=["batch_stats"],
                                         **k)[0],
            variables, *(a[1] for a in args),
            **{k: v[1] for k, v in kw.items()})
    for what, got, want in (("ec", ec_g, ec_w), ("xs", xs_g, xs_w),
                            ("g", g_g, g_w)):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want, np.float32)
        assert rel(got.float(), want) <= 1e-2, what
        assert (got.float().numpy() != want).mean() <= 1.5e-2, what


def test_bf16_generator_matches_jax(weights, monkeypatch):
    """The whole small generator, the port's graphs injected stage by
    stage: clouds fp32, rel <= 1e-2 (cloud 1) and 6e-2 (module
    docstring)."""
    gen, params, stats, model, _ = weights
    z = np.random.RandomState(4).randn(B, 128).astype(np.float32)
    model.train()
    with torch.no_grad():
        got, graphs = model(t(z), return_graphs=True)
    inject = _Graphs(graphs)
    monkeypatch.setattr(jedges, "_neighbor_idx", inject)
    with exact_knn_scope(True):
        want = _jit_apply(gen, params, stats, z)
    assert not inject.queue
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert g.shape == (B, BASE * 2 ** (i + 1), 3)
        assert rel(g, w) <= (1e-2 if i == 0 else 6e-2), (i, rel(g, w))


def _compiled(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` jitted (JAX's eager bf16 path compiles op by
    op: minutes on the CPU) with XLA's excess precision off, so that every
    bf16 rounding of the source stays (module docstring)."""
    return jax.jit(fn).lower(*args, **kwargs).compile(
        compiler_options={"xla_allow_excess_precision": False})(
            *args, **kwargs)


def _jit_apply(gen, params, stats, z):
    """The JAX generator's clouds, compiled by :func:`_compiled`."""
    return _compiled(lambda p, s, z: gen.apply(
        {"params": p, "batch_stats": s}, z, mutable=["batch_stats"])[0],
        params, stats, jnp.asarray(z))


def _matched_chamfer(a, b):
    a, b = (torch.as_tensor(np.asarray(v), dtype=torch.float64)
            for v in (a, b))
    d = torch.cdist(a, b) ** 2
    return float((d.min(2).values.mean(1) + d.min(1).values.mean(1)).mean())


def test_bf16_clouds_within_the_sampling_gap(weights):
    """bf16 clouds against fp32 clouds from the same noise (B=16): the
    port's matched Chamfer gap at most 1.25x the JAX package's own and
    under the sampling gap (module docstring)."""
    gen, params, stats, model, state = weights
    m32 = PointGenerator(base_points=BASE)
    m32.load_state_dict(state)
    g32 = jgen.PointGenerator(num_k=20, base_points=BASE)
    rs = np.random.RandomState(6)
    z, z2 = (rs.randn(16, 128).astype(np.float32) for _ in range(2))
    model.eval()
    m32.eval()
    with torch.no_grad():
        c16, c32, other = model(t(z))[3], m32(t(z))[3], m32(t(z2))[3]

    def jax_cloud(g, noise):
        with exact_knn_scope(True):
                return _jit_apply(g, params, stats, noise)[3]

    gap = _matched_chamfer(c16, c32)
    sampling = _matched_chamfer(other, c32)
    jax_gap = _matched_chamfer(jax_cloud(gen, z), jax_cloud(g32, z))
    assert gap <= 1.25 * jax_gap, (gap, jax_gap)
    assert gap <= sampling, (gap, sampling)
