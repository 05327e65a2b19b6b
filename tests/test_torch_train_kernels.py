"""The backward passes of the port's kernel modules, and its losses, on the
CPU (their plain PyTorch versions) against the JAX package on the same numpy
inputs and cotangents.

JAX runs as its own tests run it on the CPU: the local-stats kernel in
Pallas interpret mode, the head and tail through ``jax.vjp`` of their jnp
reference bodies (``exact_knn_scope(True)``: the fp32-exact graph, which is
the graph the port builds). Tolerances: local stats and slot stats rel <=
1e-5; the head's and tail's gradients rel <= 1e-4 (fp32, same math, other
summation order over longer reductions); Chamfer and the shape-preserving
terms, value and gradient, rel <= 1e-5. ``rel`` is max |a - b| / max |b|.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import head_inputs, rel, t, tail_inputs

from pdgn_tpu.losses.chamfer import chamfer_loss as jax_chamfer
from pdgn_tpu.losses.shape_preserving import get_local_pair as jax_pair
from pdgn_tpu.losses.shape_preserving import \
    shape_preserving_terms as jax_shape_terms
from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu.ops.pallas.bilateral_tail import edge_conv_tail as jax_tail
from pdgn_tpu.ops.pallas.edge_head import edge_conv_head as jax_head
from pdgn_tpu.ops.pallas.local_stats import local_mean_cov as jax_local
from pdgn_tpu.ops.pallas.slot_stats import slot_moment_stats as jax_stats
from pdgn_tpu_torch.losses.chamfer import chamfer_loss
from pdgn_tpu_torch.losses.shape_preserving import (get_local_pair,
                                                    shape_preserving_terms)
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import edge_conv_tail
from pdgn_tpu_torch.ops.kernels.edge_head import edge_conv_head
from pdgn_tpu_torch.ops.kernels.local_stats import (knn_direct,
                                                    local_mean_cov,
                                                    stats_given_idx)
from pdgn_tpu_torch.ops.kernels.slot_stats import slot_moment_stats
from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def _leaves(x):
    return [v for v in jax.tree_util.tree_leaves(x)]


def _torch_vjp(fn, inputs, cotangents):
    """Outputs and input gradients of ``fn`` (torch), None for unused."""
    ins = [None if v is None else t(v).requires_grad_(True) for v in inputs]
    outs = [o for o in _flatten(fn(*ins)) if o is not None]
    live = [i for i, v in enumerate(ins) if v is not None]
    grads = torch.autograd.grad(outs, [ins[i] for i in live],
                                [torch.as_tensor(np.asarray(c, np.float32))
                                 for c in cotangents],
                                allow_unused=True)
    full = [None] * len(ins)
    for i, g in zip(live, grads):
        full[i] = g
    return outs, full


def _flatten(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flatten(v)]
    return [x]


def _cotangents(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*np.shape(o)).astype(np.float32) for o in outs]


# ------------------------------------------------------------ local stats
def _local_case(seed, B=2, M=128, N=256):
    rng = np.random.RandomState(seed)
    src = (rng.randn(B, N, 3) * 0.4).astype(np.float32)
    centers = (rng.randn(B, M, 3) * 0.4).astype(np.float32)
    return src, centers


def _tie_case():
    """Integer-lattice shells around centers at the origin: exact distance
    ties that the k=20 cut splits mid-shell (tests/test_pallas_kernels.py:
    493)."""
    shell1 = sorted(set(itertools.permutations((1.0, 0.0, 0.0))))
    shell1 += [tuple(-c for c in p) for p in shell1]
    shell2 = sorted(set(
        p for s in itertools.product((1.0, -1.0), repeat=2)
        for p in itertools.permutations((s[0], s[1], 0.0))))
    shell3 = list(itertools.product((1.0, -1.0), repeat=3))
    far = [(9.0 + i, 9.0, 9.0) for i in range(6)]
    pts = np.array(shell1 + shell2 + shell3 + far, np.float32)[None]
    return pts, np.zeros((1, 128, 3), np.float32)


@pytest.mark.parametrize("case", ["random", "self", "ties"])
def test_local_mean_cov_and_vjp_match_pallas_interpret(case):
    """mu and the d_src VJP rel <= 1e-5 against the Pallas kernel in
    interpret mode. cov is also held to float64 on the same selection: the
    Pallas kernel sums a bf16 hi/lo split of its payload, whose own error
    is up to 1.03e-5 here (measured: random 1.03e-5, self 6.7e-6; the port
    1.8e-7 and 1.2e-7, the JAX jnp reference 1.4e-7 and 1.0e-7), so the
    port must agree with the kernel within that error plus 1e-6, and with
    the JAX jnp reference (``_reference``) within 1e-5."""
    from pdgn_tpu.ops.pallas.local_stats import _reference

    if case == "ties":
        src, centers = _tie_case()
    else:
        src, centers = _local_case(21)
        if case == "self":
            src = centers
    rng = np.random.RandomState(22)
    g_mu = rng.randn(*centers.shape).astype(np.float32)
    g_cov = rng.randn(centers.shape[0], centers.shape[1], 9).astype(
        np.float32)

    def jf(s):
        return jax_local(s, jnp.asarray(centers), 20, interpret=True)

    (mu_w, cov_w), vjp = jax.vjp(jf, jnp.asarray(src))
    (d_w,) = vjp((jnp.asarray(g_mu), jnp.asarray(g_cov)))
    cov_ref = _reference(jnp.asarray(src), jnp.asarray(centers), 20)[1]
    s = t(src).requires_grad_(True)
    mu, cov = local_mean_cov(s, t(centers), 20)
    (d_src,) = torch.autograd.grad((mu, cov), (s,), (t(g_mu), t(g_cov)))
    _, cov64 = stats_given_idx(t(src).double(),
                               knn_direct(t(src), t(centers), 20))
    assert rel(mu, mu_w) <= 1e-5
    assert rel(d_src, d_w) <= 1e-5
    assert rel(cov, cov_ref) <= 1e-5
    assert rel(cov, cov64) <= 1e-6
    assert rel(cov, cov_w) <= rel(cov_w, cov64) + 1e-6


def test_local_stats_selection_includes_the_center_and_breaks_ties_low():
    src, _ = _tie_case()
    idx = knn_direct(t(src), t(src[:, :1] * 0), 20)      # center 0
    # 6 of shell 1, 12 of shell 2, then the first 2 of shell 3 (lowest
    # index first among the equal distances)
    assert idx[0, 0].tolist() == list(range(20))
    pts = t(src)
    self_idx = knn_direct(pts, pts, 20)
    assert (self_idx[..., 0] == torch.arange(32)).all()


# ------------------------------------------------------------ head / tail
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("cx", [0, 8])
def test_edge_conv_head_vjp_matches_jax(gated, cx):
    a = head_inputs(31 + cx, cx=cx)
    k = a["k"]
    inputs = [a["x"], a["conv_kernel"], a["conv_bias"], a["merge_kernel"],
              a["pcat"] if gated else None, a["ppoint"] if gated else None,
              a["xs"]]

    def jf(x, ck, cb, mk, pcat, ppoint, xs):
        out = jax_head(x, ck, cb, mk, k, pcat, ppoint, xs=xs)
        return [o for o in _leaves(out[1:])]

    jin = [None if v is None else jnp.asarray(v) for v in inputs]
    live = [i for i, v in enumerate(jin) if v is not None]

    def jf_live(*args):
        full = list(jin)
        for i, v in zip(live, args):
            full[i] = v
        return jf(*full)

    with exact_knn_scope(True):
        outs_w, vjp = jax.vjp(jf_live, *[jin[i] for i in live])
        cts = _cotangents(outs_w, 32)
        grads_w = vjp([jnp.asarray(c) for c in cts])

    def tf(x, ck, cb, mk, pcat, ppoint, xs):
        out = edge_conv_head(x, ck, cb, mk, k, pcat, ppoint, xs=xs)
        return [o for o in _flatten(out[1:]) if o is not None]

    outs, grads = _torch_vjp(tf, inputs, cts)
    for o, w in zip(outs, outs_w):
        assert rel(o, w) <= 1e-5
    for i, gw in zip(live, grads_w):
        assert rel(grads[i], gw) <= 1e-4, i


@pytest.mark.parametrize("gated", [True, False])
def test_edge_conv_tail_vjp_matches_jax(gated):
    a = tail_inputs(41)
    k = a["k"]
    inputs = [a["partial"], a["inte"]] + list(a["inte_stats"]) + [
        a["merge_kernel"], a["merge_bias"]]
    if gated:
        inputs += [a["h"]] + list(a["w2"]) + list(a["w2_stats"])

    def call(tail_fn, v):
        h = v[8] if gated else None
        w2 = tuple(v[9:11]) if gated else None
        w2s = tuple(v[11:15]) if gated else None
        return tail_fn(v[0], v[1], h, tuple(v[2:6]), w2, w2s, v[6], v[7], k,
                       softmax=True)

    y_w, vjp = jax.vjp(lambda *v: call(jax_tail, v),
                       *[jnp.asarray(v) for v in inputs])
    (dy,) = _cotangents([y_w], 42)
    grads_w = vjp(jnp.asarray(dy))
    outs, grads = _torch_vjp(lambda *v: call(edge_conv_tail, v), inputs,
                             [dy])
    assert rel(outs[0], y_w) <= 1e-5
    for i, (g, gw) in enumerate(zip(grads, grads_w)):
        assert rel(g, gw) <= 1e-4, i


def test_slot_stats_vjp_matches_jax():
    rng = np.random.RandomState(51)
    k = 6
    h = rng.randn(2, 40, k * 64).astype(np.float32)
    ds = rng.randn(64).astype(np.float32)
    dS = rng.randn(64, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_stats(v, k), jnp.asarray(h))
    (want,) = vjp((jnp.asarray(ds), jnp.asarray(dS)))
    _, (got,) = _torch_vjp(lambda v: slot_moment_stats(v, k), [h], [ds, dS])
    assert rel(got, want) <= 1e-5


def test_backward_on_cpu_launches_no_kernel():
    _lib.LAUNCHES.clear()
    a = head_inputs(3, cx=8)
    x = t(a["x"]).requires_grad_(True)
    out = edge_conv_head(x, t(a["conv_kernel"]), t(a["conv_bias"]),
                         t(a["merge_kernel"]), a["k"], t(a["pcat"]),
                         t(a["ppoint"]), xs=t(a["xs"]))
    src = x[..., :3].contiguous()
    mu, cov = local_mean_cov(src, src.detach(), 8)
    (out[1].sum() + out[4].square().sum() + mu.sum() + cov.sum()).backward()
    assert torch.isfinite(x.grad).all()
    assert sum(_lib.LAUNCHES.values()) == 0


# ------------------------------------------------------------ losses
def test_chamfer_loss_value_and_gradient_match_jax():
    rng = np.random.RandomState(61)
    p = rng.randn(3, 50, 3).astype(np.float32)
    g = rng.randn(3, 70, 3).astype(np.float32)
    want, vjp = jax.vjp(jax_chamfer, jnp.asarray(p), jnp.asarray(g))
    dp_w, dg_w = vjp(jnp.ones_like(want))
    (got,), (dp, dg) = _torch_vjp(chamfer_loss, [p, g], [np.float32(1.0)])
    assert rel(got, want) <= 1e-5
    assert rel(dp, dp_w) <= 1e-5 and rel(dg, dg_w) <= 1e-5


def test_shape_preserving_terms_value_and_gradient_match_jax():
    rng = np.random.RandomState(62)
    clouds = [(rng.randn(2, n, 3) * 0.5).astype(np.float32)
              for n in (32, 64, 128, 256)]
    # the JAX CPU path selects neighbours on expansion distances, the port
    # on direct differences: the sets must agree on these clouds
    for i in range(3):
        for j in range(i, 4):
            a, c = t(clouds[j]), t(clouds[i])
            want_idx = torch.topk(pairwise_sqdist(c, a), 20, largest=False,
                                  sorted=True).indices
            assert torch.equal(
                torch.sort(knn_direct(a, c, 20).long(), -1).values,
                torch.sort(want_idx, -1).values)
    want, vjp = jax.vjp(lambda *c: jax_shape_terms(c),
                        *[jnp.asarray(c) for c in clouds])
    grads_w = vjp((jnp.float32(1.0), jnp.float32(2.0)))
    (mu, cov), grads = _torch_vjp(lambda *c: shape_preserving_terms(c),
                                  clouds, [np.float32(1.0), np.float32(2.0)])
    assert rel(mu, want[0]) <= 1e-5 and rel(cov, want[1]) <= 1e-5
    for g, gw in zip(grads, grads_w):
        assert rel(g, gw) <= 1e-5


def test_get_local_pair_matches_jax():
    rng = np.random.RandomState(63)
    pt1 = (rng.randn(2, 64, 3) * 0.5).astype(np.float32)
    pt2 = (rng.randn(2, 256, 3) * 0.5).astype(np.float32)
    want = jax_pair(jnp.asarray(pt1), jnp.asarray(pt2), 20)
    got = get_local_pair(t(pt1), t(pt2), 20)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-5
