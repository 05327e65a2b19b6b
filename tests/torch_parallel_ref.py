"""The JAX package's side of the port's data-parallel tests: its jitted
train step on the unpadded batch, as ``tests/test_torch_train_step.py``
runs it (base_points 16, clouds of 32-256 points, num_k 20, BN parameters
and statistics perturbed, the fp32-exact kNN regime, the shape loss's
neighbourhoods selected as the TPU kernel selects them), in float32 and
in float64, with the port's state dicts and the step's own noise for the
port to start from.

Run as a script from the repository root (``JAX_PLATFORMS=cpu python
tests/torch_parallel_ref.py --batch 3 --key 38``) it prints the gaps that
those tests state (:func:`main`)."""

import concurrent.futures
import contextlib
import functools
import os
import sys
import types

if __name__ == "__main__":      # a script: the packages from the root
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import perturb_bn
from torch_parallel_worker import BASE, SIZES

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


def _direct_local_stats(src, centers, k):
    """JAX's local statistics with its TPU kernel's selection (fp32 direct
    differences, lowest index first), as test_torch_train_step.py."""
    from pdgn_tpu.losses.shape_preserving import compute_mean_covariance
    from pdgn_tpu.ops.grouping import grouping

    diff = centers[:, :, None, :] - src[:, None, :, :]
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    _, idx = jax.lax.top_k(-d, k)
    mu, cov = compute_mean_covariance(grouping(src, idx))
    return mu, cov.reshape(*mu.shape[:2], 9)


class _Float64Numpy(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``: what the JAX
    package's modules see as ``jnp`` inside :func:`float64_scope`."""

    def __init__(self):
        super().__init__("jax.numpy")

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def float64_scope():
    """JAX's x64 mode, with the JAX package's own float32 casts, dot
    precisions and buffers read as float64: its step then traces no
    float32 value (``jax_step(..., float64=True)`` checks its jaxpr), and
    the port's converters keep float64. The JAX package's files are not
    touched; its modules' ``jnp`` and ``preferred_element_type`` constants
    are patched while the scope is open."""
    import pdgn_tpu_torch.convert_ckpt as convert

    with pytest.MonkeyPatch.context() as m, jax.enable_x64(True):
        proxy = _Float64Numpy()
        for name, mod in list(sys.modules.items()):
            if mod is None or not name.startswith("pdgn_tpu."):
                continue
            if getattr(mod, "jnp", None) is jnp:
                m.setattr(mod, "jnp", proxy)
            for attr, v in list(vars(mod).items()):
                if (isinstance(v, dict)
                        and v.get("preferred_element_type") is jnp.float32):
                    m.setattr(mod, attr,
                              dict(v, preferred_element_type=jnp.float64))
        m.setattr(convert, "_get", lambda tree, dotted: np.asarray(
            functools.reduce(lambda n, p: n[p], dotted.split("."), tree)))
        m.setattr(convert, "_tensor",
                  lambda v: torch.from_numpy(np.array(v, copy=True)))
        yield


def _to_float64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.asarray(a).dtype == jnp.float32 else a, tree)


@functools.lru_cache(maxsize=None)
def _setup(batch: int):
    """The modules, config, perturbed starting state and real clouds of
    every step at ``batch`` rows (built once a process)."""
    gen = jgen.PointGenerator(num_point=SIZES[-1], num_k=20,
                              base_points=BASE)
    discs = (PointDiscriminator1(), PointDiscriminator2(),
             PointDiscriminator3(), PointDiscriminator4())
    cfg = JaxTrainConfig()
    with exact_knn_scope(True):
        state = jax_init_state(gen, discs, cfg, jax.random.PRNGKey(0), batch,
                               num_points=SIZES)
    rs = np.random.RandomState(1)
    gp, gs = perturb_bn(state.g.params, state.g.batch_stats, rs)
    ds = []
    for d in state.d:
        p, s = perturb_bn(d.params, d.batch_stats, rs)
        ds.append(d.replace(params=p, batch_stats=s))
    state = state.replace(g=state.g.replace(params=gp, batch_stats=gs),
                          d=tuple(ds))
    reals = tuple((rs.randn(batch, n, 3) * 0.5).astype(np.float32)
                  for n in SIZES)
    return gen, discs, cfg, state, reals


def jax_step(batch: int, key: int, step: bool = True,
             float64: bool = False) -> dict:
    """The jitted JAX step at ``batch`` rows from ``PRNGKey(key)``: the
    port's starting state dicts (``g_state``, ``d_states``), the global
    ``reals`` and noise (numpy), JAX's ``metrics`` and, as port state
    dicts, its Adam first moments (``mu``) and state after the step
    (``after``), generator first. ``step=False``: the state, clouds and
    noise only.

    ``float64``: the same step with every value in float64
    (:func:`float64_scope`) from the same starting weights, clouds and
    noise: the float32 step's noise (drawn from ``key`` as that step draws
    it) is handed to the float64 step's two draws in their order. Inputs
    and results are float64."""
    return _drive([_step_stages(batch, key, step, float64)])[0]


def jax_steps(batch: int, key: int) -> tuple:
    """``jax_step(batch, key)`` and ``jax_step(batch, key, float64=True)``,
    their compilations (most of a step's time here) run at once."""
    return tuple(_drive([_step_stages(batch, key, True, f)
                         for f in (False, True)]))


def _drive(stages: list) -> list:
    """Run :func:`_step_stages` generators: each traces and lowers its
    step, in order, then every lowered step compiles on a thread of its
    own (XLA's compilation leaves the GIL), and each runs in the reverse
    order, which closes the scopes they hold in the order they opened."""
    results, lowered = [None] * len(stages), []
    try:
        for i, stage in enumerate(stages):
            try:
                lowered.append(next(stage))
            except StopIteration as done:
                lowered.append(None)
                results[i] = done.value
        with concurrent.futures.ThreadPoolExecutor(len(stages)) as pool:
            compiled = list(pool.map(
                lambda low: low and low.compile(), lowered))
        for i in reversed(range(len(stages))):
            if lowered[i] is not None:
                try:
                    stages[i].send(compiled[i])
                except StopIteration as done:
                    results[i] = done.value
    finally:
        for stage in reversed(stages):
            stage.close()
    return results


def _step_stages(batch: int, key: int, step: bool, float64: bool):
    """:func:`jax_step` as a generator for :func:`_drive`: it yields the
    lowered step, is sent the compiled one and returns the results."""
    gen, discs, cfg, state, reals = _setup(batch)
    k = jax.random.PRNGKey(key)
    noise = [np.array(cfg.noise_sigma * jax.random.normal(
        r, (batch, cfg.noise_dim))) for r in jax.random.split(k)]
    with contextlib.ExitStack() as scope:
        if float64:
            scope.enter_context(float64_scope())
            state = _to_float64(state)
            reals = tuple(r.astype(np.float64) for r in reals)
            noise = [z.astype(np.float64) for z in noise]
            draws = [jnp.asarray(z / cfg.noise_sigma) for z in noise]
            scope.enter_context(pytest.MonkeyPatch.context()).setattr(
                jax.random, "normal", lambda *a, **kw: draws.pop(0))
        out = dict(
            g_state=generator_state_from_jax(state.g.params,
                                             state.g.batch_stats),
            d_states=[discriminator_state_from_jax(d.params, d.batch_stats)
                      for d in state.d],
            reals=reals, noise_d=noise[0], noise_g=noise[1])
        if not step:
            return out
        with exact_knn_scope(True), pytest.MonkeyPatch.context() as m:
            m.setattr(jax_local_stats, "_reference", _direct_local_stats)
            args = (state, tuple(map(jnp.asarray, reals)), k)
            traced = jax.jit(make_train_step(gen, discs, cfg)).trace(*args)
            if float64:
                text = str(traced.jaxpr)
                assert "f32" not in text and "bf16" not in text
                assert not draws, "the step drew its noise otherwise"
            compiled = yield traced.lower()
            new, metrics = compiled(*args)
        mu = [generator_state_from_jax(new.g.opt_state[0].mu,
                                       new.g.batch_stats)]
        after = [generator_state_from_jax(new.g.params, new.g.batch_stats)]
        for d in new.d:
            mu.append(discriminator_state_from_jax(d.opt_state[0].mu,
                                                   d.batch_stats))
            after.append(discriminator_state_from_jax(d.params,
                                                      d.batch_stats))
    return dict(out, metrics={k_: float(v) for k_, v in metrics.items()},
                mu=mu, after=after)


def port_step(ref, dtype=None) -> dict:
    """The port's one-process step (no group) from ``jax_step``'s state,
    clouds and noise, in this process (float32, or ``dtype``); outputs as
    the ranks save them."""
    import torch

    from torch_parallel_worker import run_step

    return run_step(None, dtype=dtype or torch.float32, **rank_args(ref))


def rank_args(ref) -> dict:
    """``torch_parallel_worker.step``'s arguments from ``jax_step``'s."""
    return {k: ref[k] for k in ("g_state", "d_states", "reals", "noise_d",
                                "noise_g")}


NETS = ("G", "D1", "D2", "D3", "D4")


def gaps(out, ref_metrics, ref_grads, ref_states) -> dict:
    """A step's gaps to a reference, measured as tests/test_torch_train_step.py
    measures them: ``metrics`` the largest relative metric gap (``each``:
    every metric's); ``d`` each
    discriminator's largest first-moment gap over its largest moment;
    ``g`` and ``g_l2`` the generator's largest and relative-L2 gaps;
    ``stats`` the largest per-tensor running-statistics gap.
    ``ref_grads``/``ref_states``: per network, its first moment (flat) and
    its state dict after the step."""
    from torch_port_util import rel

    from pdgn_tpu_torch.train.train_step import METRICS

    got = out["metrics"].double().numpy()
    want = np.array([ref_metrics[k] for k in METRICS])
    each = np.abs(got - want) / np.abs(want)
    res = dict(metrics=float(each.max()), d=0.0, stats=0.0,
               each=dict(zip(METRICS, each.tolist())))
    for net, g_ref, s_ref in zip(NETS, ref_grads, ref_states):
        g = out[net]["exp_avg"]
        worst = float((g - g_ref).abs().max() / g_ref.abs().max())
        if net == "G":
            res["g"] = worst
            res["g_l2"] = float((g - g_ref).norm() / g_ref.norm())
        else:
            res["d"] = max(res["d"], worst)
        for key, v in out[net]["state"].items():
            if key.endswith(("running_mean", "running_var")):
                res["stats"] = max(res["stats"], rel(v, s_ref[key]))
    return res


def jax_reference(ref, out):
    """``gaps``'s reference arguments for the JAX step, in the parameter
    order of the port's step outputs ``out``."""
    import torch

    grads = [torch.cat([mu[n].flatten() for n in out[net]["names"]])
             for net, mu in zip(NETS, ref["mu"])]
    return ref["metrics"], grads, ref["after"]


def port_reference(out):
    """``gaps``'s reference arguments for another port step's outputs."""
    from pdgn_tpu_torch.train.train_step import METRICS

    return (dict(zip(METRICS, out["metrics"].tolist())),
            [out[net]["exp_avg"] for net in NETS],
            [out[net]["state"] for net in NETS])


# the port against the jitted JAX step, tests/test_torch_train_step.py's
# limits (its docstring says why these, and why per tensor is not possible)
JAX_LIMITS = dict(metrics=1e-4, d=1e-3, g=1e-1, g_l2=5e-2, stats=1e-3)


def within(res: dict, limits: dict) -> bool:
    return all(res[k] <= v for k, v in limits.items())


def jax_step_graphs(batch: int, key: int) -> list:
    """The kNN graph of every stage head in the jitted float32 JAX step's
    own two generator forwards, ``[[D noise, stages 1..4], [G noise,
    ...]]``, recorded by host callbacks inside ``jax_step(batch, key)``
    (a stand-alone jitted forward may round its distances otherwise)."""
    _setup(batch)               # the initialisation's forward not recorded
    found, real = {}, jgen.edge_conv_head

    def spy(*a, **kw):
        out = real(*a, **kw)
        site = len(found)
        found[site] = None
        jax.debug.callback(functools.partial(found.__setitem__, site),
                           out[0])
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jgen, "edge_conv_head", spy)
        jax_step(batch, key)
    graphs = [np.asarray(found[i]) for i in sorted(found)]
    assert len(graphs) == 8, len(graphs)
    return [graphs[:4], graphs[4:]]


def port_graphs(ref, dtype=None) -> tuple:
    """The port's one-process generator graphs of ``ref``'s two noises
    (``torch_parallel_worker.graphs``) and the features each stage head
    built its graph on (float64 numpy), in the same nesting."""
    import pdgn_tpu_torch.models.generator as tgen
    from torch_parallel_worker import graphs

    feats, real = [], tgen.edge_conv_head

    def spy(x, *a, **kw):
        feats.append(x.detach().double().numpy())
        return real(x, *a, **kw)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tgen, "edge_conv_head", spy)
        out = graphs(None, dtype=dtype or torch.float32, **rank_args(ref))
    return ([[np.asarray(g) for g in f] for f in out],
            [feats[:4], feats[4:]])


def first_ties(graphs, want, feats) -> list:
    """Per forward, where ``graphs`` first differ from ``want``: ``(stage,
    differing entries, largest relative gap)``, the gap between the
    squared distances of the two graphs' neighbours at a differing slot,
    in float64 on ``want``'s features ``feats`` (a near-tie's gap: later
    stages inherit the difference); None where every stage agrees."""
    out = []
    for fa, fb, fx in zip(graphs, want, feats):
        for stage, (a, b, x) in enumerate(zip(fa, fb, fx), 1):
            slots = np.argwhere(a != b)
            if len(slots):
                bi, ni, si = slots.T
                q = x[bi, ni]
                da = ((x[bi, a[bi, ni, si]] - q) ** 2).sum(-1)
                db = ((x[bi, b[bi, ni, si]] - q) ** 2).sum(-1)
                out.append((stage, len(slots),
                            float((np.abs(da - db) / db).max())))
                break
        else:
            out.append(None)
    return out


def jax_outputs(ref, like) -> dict:
    """JAX's step results (``jax_step``) in a port step's output form, to
    measure them by :func:`gaps` against another reference; parameters in
    the order of the port step outputs ``like``."""
    from pdgn_tpu_torch.train.train_step import METRICS

    out = dict(metrics=torch.tensor([ref["metrics"][k] for k in METRICS],
                                    dtype=torch.float64))
    for net, mu, after in zip(NETS, ref["mu"], ref["after"]):
        out[net] = dict(exp_avg=torch.cat([mu[n].flatten().double()
                                           for n in like[net]["names"]]),
                        state=after)
    return out


def _flips(a, b) -> list:
    """Differing graph entries per forward, ``[[stage 1..4], [...]]``."""
    return [[int((np.asarray(x) != np.asarray(y)).sum())
             for x, y in zip(fa, fb)] for fa, fb in zip(a, b)]


def main(argv=None) -> None:
    """Print the gaps the data-parallel tests state, for one batch size and
    key (``gaps``' measures): the port's one-process and two-rank steps in
    float32 and float64 against JAX's jitted float32 and float64 steps and
    each other, JAX's float32 step against its float64 step, the
    one-process step with its rows reordered, the differing kNN graph
    entries of the generator's forwards (two ranks against one process),
    and where the two ranks' float32 graphs and the graphs inside JAX's
    float32 step first differ from the port's float64 graphs, with the
    near-tie's gap (:func:`first_ties`)."""
    import argparse
    import json
    import tempfile

    import torch_parallel_worker as workers

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--key", type=int, default=28)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    ref, ref64 = jax_steps(args.batch, args.key)
    one, one64 = port_step(ref), port_step(ref, torch.float64)
    tasks = [("step", rank_args(ref)), ("step64", rank_args(ref)),
             ("graphs", rank_args(ref))]
    with tempfile.TemporaryDirectory() as tmp:
        two = workers.spawn(tmp, 2, tasks)
    two32, two64 = two["step"][0], two["step64"][0]
    perm = list(range(args.batch))[::-1]
    reordered = dict(ref, reals=tuple(r[perm] for r in ref["reals"]),
                     noise_d=ref["noise_d"][perm],
                     noise_g=ref["noise_g"][perm])
    one_graphs, _ = port_graphs(ref)
    graphs64, feats64 = port_graphs(ref, torch.float64)
    two_graphs = [[np.concatenate([a, b]) for a, b in zip(fa, fb)]
                  for fa, fb in zip(*two["graphs"])]
    res = {
        "one_f32_vs_jax": gaps(one, *jax_reference(ref, one)),
        "one_f32_vs_jax_f64": gaps(one, *jax_reference(ref64, one)),
        "jax_f32_vs_jax_f64": gaps(jax_outputs(ref, one),
                                   *jax_reference(ref64, one)),
        "one_f64_vs_jax_f64": gaps(one64, *jax_reference(ref64, one)),
        "one_reordered_vs_one": gaps(port_step(reordered),
                                     *port_reference(one)),
        "two_f32_vs_jax": gaps(two32, *jax_reference(ref, two32)),
        "two_f32_vs_jax_f64": gaps(two32, *jax_reference(ref64, two32)),
        "two_f64_vs_jax_f64": gaps(two64, *jax_reference(ref64, two64)),
        "two_f32_vs_one_f32": gaps(two32, *port_reference(one)),
        "two_f64_vs_one_f64": gaps(two64, *port_reference(one64)),
        "graph_flips_two_vs_one": _flips(two_graphs, one_graphs),
        "graph_flips_one_f32_vs_f64": _flips(one_graphs, graphs64),
        "two_f32_graphs_vs_port_f64": first_ties(two_graphs, graphs64,
                                                 feats64),
        "jax_step_graphs_vs_port_f64": first_ties(
            jax_step_graphs(args.batch, args.key), graphs64, feats64),
    }
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
