"""The port's kernel modules on the CPU (their plain PyTorch versions)
against the JAX package's CPU path, on the same numpy inputs.

JAX runs with ``interpret=False`` off-TPU inside ``exact_knn_scope(True)``:
the fp32-exact graph and the jnp reference bodies (not the interpret-mode
head, which selects on bf16 keys). Tolerance: idx identical; everything
else rel <= 1e-5 (fp32, the same decomposition, different summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import head_inputs as _head_inputs
from torch_port_util import rel, t
from torch_port_util import tail_inputs as _tail_inputs

from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu.ops.pallas.bilateral_tail import edge_conv_tail as jax_tail
from pdgn_tpu.ops.pallas.edge_head import edge_conv_head as jax_head
from pdgn_tpu.ops.pallas.slot_stats import slot_moment_stats as jax_stats
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import edge_conv_tail
from pdgn_tpu_torch.ops.kernels.edge_head import edge_conv_head
from pdgn_tpu_torch.ops.kernels.slot_stats import slot_moment_stats

TOL = 1e-5


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("cx", [0, 8])
def test_edge_conv_head_matches_jax(gated, cx):
    a = _head_inputs(11 + cx, cx=cx)
    k = a["k"]
    pc = (a["pcat"], a["ppoint"]) if gated else (None, None)
    with exact_knn_scope(True):
        want = jax_head(jnp.asarray(a["x"]), jnp.asarray(a["conv_kernel"]),
                        jnp.asarray(a["conv_bias"]),
                        jnp.asarray(a["merge_kernel"]), k,
                        *(None if p is None else jnp.asarray(p) for p in pc),
                        xs=None if a["xs"] is None else jnp.asarray(a["xs"]))
    got = edge_conv_head(t(a["x"]), t(a["conv_kernel"]), t(a["conv_bias"]),
                         t(a["merge_kernel"]), k,
                         *(None if p is None else t(p) for p in pc),
                         xs=None if a["xs"] is None else t(a["xs"]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for name, g, w in (("inte", got[1], want[1]), ("partial", got[2], want[2]),
                       ("mean", got[3][0], want[3][0]),
                       ("var", got[3][1], want[3][1])):
        assert rel(g, w) <= TOL, name
    if gated:
        for name, g, w in (("wfea", got[4], want[4]), ("wxyz", got[5], want[5]),
                           ("fea_mean", got[6][0], want[6][0]),
                           ("fea_var", got[6][1], want[6][1]),
                           ("xyz_mean", got[7][0], want[7][0]),
                           ("xyz_var", got[7][1], want[7][1])):
            assert rel(g, w) <= TOL, name
    else:
        assert got[4] is None and want[4] is None


def test_slot_moment_stats_matches_jax():
    rng = np.random.RandomState(3)
    k, H = 6, 64
    h = rng.randn(2, 40, k * H).astype(np.float32)
    s_want, S_want = jax_stats(jnp.asarray(h), k)
    s_got, S_got = slot_moment_stats(t(h), k)
    assert rel(s_got, s_want) <= TOL
    assert rel(S_got, S_want) <= TOL


@pytest.mark.parametrize("gated", [True, False])
def test_edge_conv_tail_matches_jax(gated):
    a = _tail_inputs(5)
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    h = a["h"] if gated else None
    w2 = a["w2"] if gated else None
    w2s = a["w2_stats"] if gated else None
    want = jax_tail(j(a["partial"]), j(a["inte"]), j(h),
                    tuple(map(j, a["inte_stats"])),
                    None if w2 is None else tuple(map(j, w2)),
                    None if w2s is None else tuple(map(j, w2s)),
                    j(a["merge_kernel"]), j(a["merge_bias"]), a["k"],
                    softmax=True)
    got = edge_conv_tail(t(a["partial"]), t(a["inte"]),
                         None if h is None else t(h),
                         tuple(map(t, a["inte_stats"])),
                         None if w2 is None else tuple(map(t, w2)),
                         None if w2s is None else tuple(map(t, w2s)),
                         t(a["merge_kernel"]), t(a["merge_bias"]), a["k"],
                         softmax=True)
    assert got.shape == want.shape
    assert rel(got, want) <= TOL


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors route to the plain versions: no kernel is built or
    launched, so every launch counter stays 0."""
    _lib.LAUNCHES.clear()
    a = _head_inputs(2, cx=8)
    out = edge_conv_head(t(a["x"]), t(a["conv_kernel"]), t(a["conv_bias"]),
                         t(a["merge_kernel"]), a["k"], t(a["pcat"]),
                         t(a["ppoint"]), xs=t(a["xs"]))
    slot_moment_stats(torch.randn(2, 8, 6 * 64), 6)
    b = _tail_inputs(4)
    edge_conv_tail(t(b["partial"]), t(b["inte"]), None,
                   tuple(map(t, b["inte_stats"])), None, None,
                   t(b["merge_kernel"]), t(b["merge_bias"]), b["k"])
    assert out[0].dtype == torch.int32
    assert sum(_lib.LAUNCHES.values()) == 0
    assert _lib._lib is None


def test_wrappers_check_their_inputs():
    a = _head_inputs(1)
    with pytest.raises(TypeError):
        slot_moment_stats(torch.zeros(2, 8, 6 * 64, dtype=torch.float16), 6)
    with pytest.raises(ValueError):
        slot_moment_stats(torch.zeros(2, 8, 6 * 64).transpose(0, 1), 6)
    with pytest.raises(ValueError):
        edge_conv_head(t(a["x"]), t(a["conv_kernel"]), t(a["conv_bias"]),
                       t(a["merge_kernel"]), 5)
