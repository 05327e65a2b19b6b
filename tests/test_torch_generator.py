"""The port's generator against the JAX package's, on the same weights
(carried by ``generator_state_from_jax``) and the same numpy noise.

JAX runs in its fp32-exact kNN regime (``exact_knn_scope(True)``), which is
the regime the port implements. Tolerances: every stage fed identical
inputs rel <= 1e-4 with identical graphs; the whole small generator
(B=4, num_k 20, base_points 16: clouds of 32..256 points) rel <= 1e-3 with
identical graphs at every stage.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import perturb_bn, rel, t

import pdgn_tpu.models.generator as jgen
from pdgn_tpu.convert_ckpt import convert_generator
from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu_torch.convert_ckpt import generator_state_from_jax
from pdgn_tpu_torch.models.generator import PointGenerator, _global_branch

BASE = 16
B = 4


@pytest.fixture(scope="module")
def weights():
    """Small JAX generator variables with random BN parameters/statistics,
    and the port generator loaded from them."""
    gen = jgen.PointGenerator(base_points=BASE)
    with exact_knn_scope(True):
        v = gen.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))
    params, stats = perturb_bn(v["params"], v["batch_stats"],
                               np.random.RandomState(0))
    model = PointGenerator(base_points=BASE)
    model.load_state_dict(generator_state_from_jax(params, stats))
    return gen, params, stats, model


def _run_jax(gen, params, stats, z):
    """JAX forward recording each stage's kNN graph."""
    graphs = []
    real = jgen.edge_conv_head

    def spy(*a, **kw):
        out = real(*a, **kw)
        graphs.append(np.asarray(out[0]))
        return out

    jgen.edge_conv_head = spy
    try:
        with exact_knn_scope(True):
            outs, new_vars = gen.apply({"params": params,
                                        "batch_stats": stats},
                                       jnp.asarray(z),
                                       mutable=["batch_stats"])
    finally:
        jgen.edge_conv_head = real
    return outs, graphs, new_vars["batch_stats"]


def test_generator_matches_jax_with_identical_graphs(weights):
    gen, params, stats, model = weights
    z = np.random.RandomState(4).randn(B, 128).astype(np.float32)
    want, want_graphs, _ = _run_jax(gen, params, stats, z)
    model.train()
    with torch.no_grad():
        got, graphs = model(t(z), return_graphs=True)
    assert len(graphs) == len(want_graphs) == 4
    for i, (g, w) in enumerate(zip(graphs, want_graphs)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"stage {i + 1}")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, BASE * 2 ** (i + 1), 3)
        assert rel(g, w) <= 1e-3, f"cloud {i + 1}: {rel(g, w)}"


def test_running_statistics_update_like_jax(weights):
    """A training-mode forward folds the batch statistics into the running
    averages exactly as flax's mutable batch_stats do."""
    gen, params, stats, _ = weights
    model = PointGenerator(base_points=BASE)
    model.load_state_dict(generator_state_from_jax(params, stats))
    z = np.random.RandomState(4).randn(B, 128).astype(np.float32)
    _, _, new_stats = _run_jax(gen, params, stats, z)
    model.train()
    with torch.no_grad():
        model(t(z))
    want = generator_state_from_jax(params, new_stats)
    got = model.state_dict()
    for key in want:
        if key.endswith(("running_mean", "running_var")):
            assert rel(got[key], want[key]) <= 1e-4, key


def _global_branch_f64(block, x, xs_in):
    """The block's global branch (``xs`` and ``g``) in float64 on the same
    inputs: the arbiter of the two fp32 results."""
    b64 = copy.deepcopy(block).double()
    pooled = torch.amax(x.double(), dim=1)
    if xs_in is not None:
        pooled = torch.cat([xs_in.double(), pooled], dim=-1)
    with torch.no_grad():
        return _global_branch(b64.fc, b64.g_fc, pooled)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_each_stage_matches_jax(weights, stage):
    """Each BilateralBlock fed identical (random) inputs.

    ``ec`` is held to the JAX result, rel <= 1e-4. ``xs`` and ``g`` leave
    the block through BatchNorms over only B=4 rows in the E[x^2]-E[x]^2
    form, which amplifies the rounding of the fp32 matmuls (torch's and
    XLA's CPU products round differently, and with the thread count), so
    there each fp32 result is held to the block's global branch run in
    float64: the port's error at most 4x the JAX package's own. Measured
    (rel to float64, JAX / port): stage 1 xs 1.47e-5 / 1.46e-5, g 1.48e-4 /
    1.50e-4; stage 2 xs 1.73e-6 / 1.65e-6, g 7.5e-6 / 6.7e-6; stage 3 xs
    7.3e-6 / 8.0e-6, g 1.14e-5 / 6.3e-6; stage 4 xs 5.33e-5 / 5.60e-5. At
    stage 4 the two errors have opposite signs, so port against JAX is
    1.04e-4, which a direct 1e-4 limit refused.
    """
    _, params, stats, model = weights
    fin = 32 * 2 ** (stage - 1)
    n = BASE * 2 ** (stage - 1)
    rng = np.random.RandomState(40 + stage)
    name = f"bilateral{stage}"
    mod = jgen.BilateralBlock(fin, fin, 10, bilateral=stage > 1,
                              with_g=stage < 4, name=name)
    if stage == 1:
        x = rng.randn(B, n, fin).astype(np.float32)
        jargs, targs, kw, tkw = (jnp.asarray(x),), (t(x),), {}, {}
    else:
        x = rng.randn(B, n, fin // 2).astype(np.float32)
        pc = rng.randn(B, n, 3).astype(np.float32)
        xs = rng.randn(B, fin // 2).astype(np.float32)
        jargs, targs = (jnp.asarray(x), jnp.asarray(pc)), (t(x), t(pc))
        kw, tkw = {"xs_in": jnp.asarray(xs)}, {"xs_in": t(xs)}
    with exact_knn_scope(True):
        (xs_w, g_w, ec_w), _ = mod.apply(
            {"params": params[name], "batch_stats": stats[name]}, *jargs,
            mutable=["batch_stats"], **kw)
    block = getattr(model, name)
    block.train()
    with torch.no_grad():
        xs_g, g_g, ec_g, _ = block(*targs, **tkw)
    assert rel(ec_g, ec_w) <= 1e-4
    xs_64, g_64 = _global_branch_f64(block, targs[0], tkw.get("xs_in"))
    pairs = [("xs", xs_g, xs_w, xs_64)]
    if stage < 4:
        pairs.append(("g", g_g, g_w, g_64))
    else:
        assert g_g is None and g_w is None
    for name, got, want, arbiter in pairs:
        err_jax, err_port = rel(want, arbiter), rel(got, arbiter)
        assert err_jax <= 1e-3, f"{name}: JAX fp32 rel {err_jax}"
        assert err_port <= 4 * err_jax, (
            f"{name}: port rel {err_port} vs JAX rel {err_jax}")


def test_converter_round_trips_to_jax_exactly(weights):
    _, params, stats, model = weights
    sd = generator_state_from_jax(params, stats)
    assert all(int(v) == 0 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))
    back, _ = convert_generator({k: v.numpy() for k, v in sd.items()})
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat_p:
        got = back["params"]
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)
    for path, leaf in jax.tree_util.tree_leaves_with_path(stats):
        got = back["batch_stats"]
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)
    assert (len(jax.tree.leaves(back["params"]))
            == len(jax.tree.leaves(params)))


def test_full_width_parameter_count_and_names():
    from pdgn_tpu.convert_ckpt import generator_rules

    with torch.device("meta"):
        model = PointGenerator()
    assert sum(p.numel() for p in model.parameters()) == 12_711_372
    want = set()
    for prefix, kind, _ in generator_rules():
        want |= {f"{prefix}.weight", f"{prefix}.bias"}
        if kind in ("bn", "bn_block"):
            want |= {f"{prefix}.{s}" for s in
                     ("running_mean", "running_var", "num_batches_tracked")}
    assert set(model.state_dict()) == want
