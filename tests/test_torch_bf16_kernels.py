"""The bf16 instances' plain versions (the CPU path of ``--compute_dtype
bfloat16``) against the JAX package's bf16 path, on the same bf16 inputs.

JAX runs its XLA path on the CPU in the fp32-exact kNN regime
(``exact_knn_scope(True)``), with ``dtype`` bf16 inputs as its generator
gives them. Its exact graph of bf16 features is not the exact graph of
those values: ``self_pairwise_sqdist`` takes the row norms in the input's
dtype (pdgn_tpu/ops/pairwise.py:54), so they are rounded to bf16, while the
TPU kernel takes them in fp32 from the upcast (edge_head.py:340-342), as
the port does. So the head's comparison feeds JAX the port's graph
(``pdgn_tpu.ops.edges._neighbor_idx`` patched here; nothing in
``pdgn_tpu`` changes), and the port's bf16 graph is held to the float64
graph of the same bf16 values instead.

Tolerances, measured here. bf16 outputs (inte, wfea, wxyz, the tails' y)
in bf16 ulps of the larger magnitude, counted at no less than 1/256 of the
tensor's largest (``bf16_ulps``): the two sides sum the same exact fp32
products in other orders and round once, so a value within fp32 rounding
of a bf16 midpoint may round the other way. Measured: the head's inte
0.002 (one value far below 1/256 of the largest, one ulp of its own),
wfea and wxyz 0, both tails 0. Limit 1. fp32 outputs: partial, the
batch-norm means and variances, s and S, measured rel <= 1.01e-6, limit
1e-5. The graph: equal to float64's but at near-ties (PERF.md section 2's
rule: at most 0.1% of entries, each within 1e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import bf16_pair, bf16_ulps, rel, t
from torch_port_util import head_inputs as _head_inputs
from torch_port_util import tail_inputs as _tail_inputs

import pdgn_tpu.ops.edges as jedges
from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu.ops.pallas.bilateral_tail import edge_conv_tail as jax_tail
from pdgn_tpu.ops.pallas.edge_head import edge_conv_head as jax_head
from pdgn_tpu.ops.pallas.slot_stats import _jnp_stats
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import edge_conv_tail
from pdgn_tpu_torch.ops.kernels.edge_head import edge_conv_head
from pdgn_tpu_torch.ops.kernels.slot_stats import slot_moment_stats

ULPS = 1.0
TOL = 1e-5


def _head_case(seed, cx, gated):
    a = _head_inputs(seed, B=2, N=64, C=16, cx=cx, k=10, two_f=24)
    x_t, x_j = bf16_pair(a["x"])
    xs = bf16_pair(a["xs"]) if cx else (None, None)
    pc = [bf16_pair(a[n]) for n in ("pcat", "ppoint")] if gated else None
    return a, (x_t, x_j), xs, pc


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("cx", [0, 16])
def test_bf16_head_matches_jax_given_the_graph(gated, cx, monkeypatch):
    a, (x_t, x_j), (xs_t, xs_j), pc = _head_case(21 + cx, cx, gated)
    k = a["k"]
    w = [a[n] for n in ("conv_kernel", "conv_bias", "merge_kernel")]
    got = edge_conv_head(x_t, *map(t, w), k,
                         *(p[0] for p in pc) if gated else (None, None),
                         xs=xs_t)
    idx = got[0].numpy()
    monkeypatch.setattr(jedges, "_neighbor_idx",
                        lambda x, kk: jnp.asarray(idx))
    with exact_knn_scope(True):
        want = jax_head(x_j, *map(jnp.asarray, w), k,
                        *(p[1] for p in pc) if gated else (None, None),
                        xs=xs_j)
    assert got[1].dtype == torch.bfloat16 and want[1].dtype == jnp.bfloat16
    assert bf16_ulps(got[1], np.asarray(want[1], np.float32)) <= ULPS
    assert got[2].dtype == torch.float32
    assert rel(got[2], want[2]) <= TOL
    for i in (0, 1):
        assert rel(got[3][i], want[3][i]) <= TOL
    if not gated:
        assert got[4] is None and want[4] is None
        return
    for i in (4, 5):
        assert got[i].dtype == torch.bfloat16
        assert bf16_ulps(got[i], np.asarray(want[i], np.float32)) <= ULPS
    for i in (6, 7):
        for j in (0, 1):
            assert rel(got[i][j], want[i][j]) <= TOL


@pytest.mark.parametrize("cx", [0, 16])
def test_bf16_graph_is_float64s_of_the_same_values(cx):
    """The port's bf16 graph against the float64 graph of the same bf16
    values (self dropped, lowest index first), near-tie rule; JAX's own
    bf16 exact graph is not held to it (see the module docstring)."""
    a, (x_t, _), (xs_t, _), _ = _head_case(31 + cx, cx, False)
    k = a["k"]
    idx = edge_conv_head(x_t, t(a["conv_kernel"]), t(a["conv_bias"]),
                         t(a["merge_kernel"]), k, xs=xs_t)[0]
    x = x_t.double()
    if cx:
        x = torch.cat([xs_t.double()[:, None, :].expand(-1, x.shape[1], -1),
                       x], dim=-1)
    d = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    n = d.shape[1]
    d = d + torch.eye(n, dtype=d.dtype) * 1e300      # self dropped
    order = torch.argsort(d * (1 + 1e-12) + torch.arange(n) * 1e-300,
                          dim=-1, stable=True)[..., :k]
    mism = idx.long() != order
    frac = float(mism.float().mean())
    assert frac <= 1e-3
    if frac:
        dk = d.gather(-1, idx.long())
        dw = d.gather(-1, order)
        gap = ((dk - dw).abs() / dk.maximum(dw))[mism].max()
        assert float(gap) <= 1e-5


def test_bf16_slot_stats_matches_jax():
    rng = np.random.RandomState(7)
    k = 10
    h_t, h_j = bf16_pair(rng.randn(2, 48, k * 64))
    s_want, S_want = _jnp_stats(h_j, k)
    s_got, S_got = slot_moment_stats(h_t, k)
    assert s_got.dtype == S_got.dtype == torch.float32
    assert rel(s_got, s_want) <= TOL
    assert rel(S_got, S_want) <= TOL


@pytest.mark.parametrize("gated", [True, False])
def test_bf16_tails_match_jax(gated):
    """Both tails on bf16 inte and h against the JAX entry's bf16 path
    (``bilateral_tail._reference`` with its three roundings)."""
    a = _tail_inputs(9, N=48, k=10)
    inte_t, inte_j = bf16_pair(a["inte"])
    h_t, h_j = bf16_pair(a["h"]) if gated else (None, None)
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    w2 = a["w2"] if gated else None
    w2s = a["w2_stats"] if gated else None
    want = jax_tail(j(a["partial"]), inte_j, h_j,
                    tuple(map(j, a["inte_stats"])),
                    None if w2 is None else tuple(map(j, w2)),
                    None if w2s is None else tuple(map(j, w2s)),
                    j(a["merge_kernel"]), j(a["merge_bias"]), a["k"])
    got = edge_conv_tail(t(a["partial"]), inte_t, h_t,
                         tuple(map(t, a["inte_stats"])),
                         None if w2 is None else tuple(map(t, w2)),
                         None if w2s is None else tuple(map(t, w2s)),
                         t(a["merge_kernel"]), t(a["merge_bias"]), a["k"])
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert bf16_ulps(got, np.asarray(want, np.float32)) <= ULPS


def test_bf16_wrappers_take_the_plain_path_and_have_no_backward():
    """bf16 CPU tensors run the plain versions (no launch), forward and,
    since bf16 training is ported, backward: a bf16 head, tail or
    slot-stats call differentiates through its plain bf16 backward
    (tests/test_torch_bf16_train_kernels.py holds those to the TPU
    kernels); an unported dtype refuses the call. The name is kept from
    when the bf16 wrappers had no backward."""
    _lib.LAUNCHES.clear()
    a, (x_t, _), (xs_t, _), pc = _head_case(5, 16, True)
    w = [t(a[n]).requires_grad_(True)
         for n in ("conv_kernel", "conv_bias", "merge_kernel")]
    out = edge_conv_head(x_t, *w, a["k"], pc[0][0], pc[1][0], xs=xs_t)
    out[2].sum().backward()
    assert all(v.grad is not None and v.grad.dtype == torch.float32
               for v in w)
    h = torch.randn(2, 8, 6 * 64).bfloat16().requires_grad_(True)
    slot_moment_stats(h, 6)[1].sum().backward()
    assert h.grad.dtype == torch.bfloat16
    b = _tail_inputs(4)
    stats = tuple(t(v).requires_grad_(True) for v in b["inte_stats"])
    y = edge_conv_tail(t(b["partial"]), t(b["inte"]).bfloat16(), None, stats,
                       None, None, t(b["merge_kernel"]), t(b["merge_bias"]),
                       b["k"])
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all()
               for v in stats)
    assert sum(_lib.LAUNCHES.values()) == 0
    with pytest.raises(TypeError):
        slot_moment_stats(torch.zeros(2, 8, 6 * 64, dtype=torch.float16), 6)
