"""One whole GAN train step of the port against the JAX package's step, from
the same state (weights carried by the converters, BN parameters and
statistics perturbed), the same real clouds and the same noise (the JAX
step's own noise, computed from its key and handed to the port).

Small configuration: base_points 16 (clouds of 32/64/128/256 points),
B=4, num_k 20; JAX in its fp32-exact kNN regime (``exact_knn_scope(True)``),
jitted as its trainer runs it, and both generator forwards are checked to
build the graphs of the jitted JAX forward. The JAX shape loss selects its
neighbourhoods as the JAX package's TPU kernel does (direct differences, see
``_direct_local_stats``), which is the port's selection.

Gradients are compared through Adam's first moment after the step (optax
``mu``, torch ``exp_avg``, both ``(1 - beta1) * g``); the updated weights are
not compared element by element: the first Adam step is about -lr * sign(g),
which flips for a gradient near zero.

Tolerances, and why. This step is badly conditioned in fp32: the
generator's global branch normalises over B=4 rows, and biases that feed a
batch norm have a gradient that is zero but for rounding. The JAX package's
own eager and jitted steps (same code, same inputs, only XLA's rounding
differs) were measured against each other at key 28: metrics within 2.1e-5,
discriminator gradients within 3.8e-4 of each network's largest gradient,
generator gradients within 1.51e-1 of it. The port against the jitted step,
measured the same way: metrics 2.0e-5, discriminators 3.9e-4, generator
4.7e-2 (relative L2 over the generator 1.7e-2), BN running statistics per
tensor 3.8e-4. The limits: metrics rel <= 1e-4; discriminator gradients
<= 1e-3 of the network's largest; generator gradients <= 1e-1 of it and
relative L2 <= 5e-2; running statistics per tensor rel <= 1e-3. A
per-tensor 1e-3 limit on gradients is not attainable: JAX's own two
executions disagree by more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import perturb_bn, rel, t

import pdgn_tpu.models.generator as jgen
import pdgn_tpu.ops.pallas.local_stats as jax_local_stats
from pdgn_tpu.models import (PointDiscriminator1, PointDiscriminator2,
                             PointDiscriminator3, PointDiscriminator4)
from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu.train import TrainConfig as JaxTrainConfig
from pdgn_tpu.train import init_state as jax_init_state
from pdgn_tpu.train import make_train_step
from pdgn_tpu_torch.convert_ckpt import (discriminator_state_from_jax,
                                         generator_state_from_jax)
from pdgn_tpu_torch.models import discriminator as tdisc
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.train.train_step import (METRICS, TrainConfig,
                                             init_state, train_step)

BASE = 16
SIZES = (32, 64, 128, 256)
B = 4
# The step's key. XLA rounds the stage-3/4 kNN distances otherwise than
# the port, and at this size near-ties are common: for keys 7..29, 15 of 23
# jitted forwards order at least two graph entries otherwise than the
# port, which changes the clouds at the 1e-2 level. With key 28 both
# forwards of the step build the same graphs in the two packages.
KEY = 28


def _direct_local_stats(src, centers, k):
    """The JAX local statistics with the selection of the JAX package's
    TPU kernel (ops/pallas/local_stats.py): fp32 direct differences, lowest
    index first; the moments are the package's ``compute_mean_covariance``.
    Its CPU fallback selects on the ``|x|^2 - 2<x,y> + |y|^2`` expansion,
    whose rounding picks other neighbours at near-ties."""
    from pdgn_tpu.losses.shape_preserving import compute_mean_covariance
    from pdgn_tpu.ops.grouping import grouping

    diff = centers[:, :, None, :] - src[:, None, :, :]
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    _, idx = jax.lax.top_k(-d, k)
    mu, cov = compute_mean_covariance(grouping(src, idx))
    return mu, cov.reshape(*mu.shape[:2], 9)


def _jax_graphs(gen):
    """Jitted JAX generator forward returning each stage's kNN graph."""
    real = jgen.edge_conv_head

    def forward(params, stats, z):
        graphs = []

        def spy(*a, **kw):
            out = real(*a, **kw)
            graphs.append(out[0])
            return out

        jgen.edge_conv_head = spy
        try:
            gen.apply({"params": params, "batch_stats": stats}, z,
                      mutable=["batch_stats"])
        finally:
            jgen.edge_conv_head = real
        return graphs

    return jax.jit(forward)


@pytest.fixture(scope="module")
def stepped():
    gen = jgen.PointGenerator(num_point=SIZES[-1], num_k=20,
                              base_points=BASE)
    discs = (PointDiscriminator1(), PointDiscriminator2(),
             PointDiscriminator3(), PointDiscriminator4())
    cfg = JaxTrainConfig()
    with exact_knn_scope(True):
        state = jax_init_state(gen, discs, cfg, jax.random.PRNGKey(0), B,
                               num_points=SIZES)
    rs = np.random.RandomState(1)
    gp, gs = perturb_bn(state.g.params, state.g.batch_stats, rs)
    ds = []
    for d in state.d:
        p, s = perturb_bn(d.params, d.batch_stats, rs)
        ds.append(d.replace(params=p, batch_stats=s))
    state = state.replace(g=state.g.replace(params=gp, batch_stats=gs),
                          d=tuple(ds))
    reals = tuple((rs.randn(B, n, 3) * 0.5).astype(np.float32)
                  for n in SIZES)
    key = jax.random.PRNGKey(KEY)
    with exact_knn_scope(True), pytest.MonkeyPatch.context() as m:
        m.setattr(jax_local_stats, "_reference", _direct_local_stats)
        new_state, metrics = jax.jit(make_train_step(gen, discs, cfg))(
            state, tuple(map(jnp.asarray, reals)), key)
    rng_d, rng_g = jax.random.split(key)
    noise = [np.asarray(cfg.noise_sigma * jax.random.normal(
        r, (B, cfg.noise_dim))) for r in (rng_d, rng_g)]

    G = PointGenerator(num_point=SIZES[-1], base_points=BASE)
    G.load_state_dict(generator_state_from_jax(gp, gs))
    Ds = []
    for i, d in enumerate(ds, 1):
        m = getattr(tdisc, f"PointDiscriminator{i}")()
        m.load_state_dict(discriminator_state_from_jax(d.params,
                                                       d.batch_stats))
        Ds.append(m)
    graphs = {}
    jax_graphs = _jax_graphs(gen)
    G.eval()        # batch statistics still; the running ones stay put
    for name, z in zip(("d", "g"), noise):
        with torch.no_grad():
            _, got = G(t(z), return_graphs=True)
        with exact_knn_scope(True):
            want = [np.asarray(g) for g in jax_graphs(gp, gs, jnp.asarray(z))]
        graphs[name] = (got, want)
    G.train()
    tstate = init_state(G, Ds, TrainConfig())
    tmetrics = train_step(tstate, [t(r) for r in reals], t(noise[0]),
                          t(noise[1]), TrainConfig())
    return dict(state=new_state, metrics=metrics, tstate=tstate,
                tmetrics=tmetrics, graphs=graphs)


def test_both_generator_forwards_build_identical_graphs(stepped):
    for name, (got, want) in stepped["graphs"].items():
        assert len(got) == len(want) == 4
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name} stage {i + 1}")


def test_step_metrics_match_jax(stepped):
    for key in METRICS:
        got = float(stepped["tmetrics"][key])
        want = float(stepped["metrics"][key])
        assert np.isfinite(got)
        assert abs(got - want) <= 1e-4 * abs(want), (key, got, want)


def _adam_mu(state):
    return state.opt_state[0].mu


def _nets(stepped):
    """(port model, its optimizer, JAX mu as a state dict, JAX state after
    the step as a state dict) for G and each D."""
    s, ts = stepped["state"], stepped["tstate"]
    out = [(ts.generator, ts.g_opt,
            generator_state_from_jax(_adam_mu(s.g), s.g.batch_stats),
            generator_state_from_jax(s.g.params, s.g.batch_stats))]
    for d, td, opt in zip(s.d, ts.discriminators, ts.d_opts):
        out.append((td, opt,
                    discriminator_state_from_jax(_adam_mu(d), d.batch_stats),
                    discriminator_state_from_jax(d.params, d.batch_stats)))
    return out


def test_gradients_match_jax_through_adam_first_moment(stepped):
    for i, (model, opt, want, _) in enumerate(_nets(stepped)):
        names = [n for n, _ in model.named_parameters()]
        got = torch.cat([opt.state[p]["exp_avg"].flatten()
                         for p in model.parameters()])
        ref = torch.cat([want[n].flatten() for n in names])
        assert got.shape == ref.shape
        worst = float((got - ref).abs().max() / ref.abs().max())
        if i == 0:
            l2 = float((got - ref).norm() / ref.norm())
            assert worst <= 1e-1 and l2 <= 5e-2, (worst, l2)
        else:
            assert worst <= 1e-3, (i, worst)


def test_running_statistics_match_jax(stepped):
    for model, _, _, want in _nets(stepped):
        for key, v in model.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                assert rel(v, want[key]) <= 1e-3, key


def test_step_moves_only_what_it_should(stepped):
    ts = stepped["tstate"]
    assert ts.step == 1
    for m in (ts.generator,) + ts.discriminators:
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in m.parameters())
