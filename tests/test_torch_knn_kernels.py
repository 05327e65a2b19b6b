"""The plain versions of the port's kNN kernels (``knn_topk_reference``,
``knn_gather_reference``; CPU tensors take them) against the TPU kernels of
pdgn_tpu/ops/pallas/knn.py run in interpret mode, as
tests/test_pallas_kernels.py runs them, and the port's ``EdgeConv``
against the flax module on the same parameters.

Tolerances: indices equal on both distance branches (C <= 4 direct
differences, C > 4 the norm expansion); nbr exact against JAX
``grouping(x, _neighbor_idx(x, k))`` and rel <= 1e-4 against the TPU
kernel's bf16 hi/lo gather (its own limit, ~2^-16 relative); the gradient
of sum(nbr^2) rel <= 1e-5 against JAX's through ``grouping`` (the same
scatter-add, summed in another order); EdgeConv's output, running
statistics and gradients rel <= 1e-5 (fp32 matmuls and batch-norm sums in
two libraries' orders; the conv bias, whose gradient is 0 but for rounding,
to 1e-5 of the largest weight gradient), the converter's round trip exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import perturb_bn, rel, t

from pdgn_tpu.models import EdgeConv as JEdgeConv
from pdgn_tpu.ops.edges import _neighbor_idx
from pdgn_tpu.ops.grouping import grouping as j_grouping
from pdgn_tpu.ops.knn import knn_naive
from pdgn_tpu.ops.pallas.knn import knn_gather as j_knn_gather
from pdgn_tpu.ops.pallas.knn import knn_topk as j_knn_topk
from pdgn_tpu_torch.convert_ckpt import edge_conv_state_from_jax
from pdgn_tpu_torch.models.generator import EdgeConv
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.knn import (knn_gather, knn_gather_reference,
                                            knn_topk, knn_topk_reference)


def cloud(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("C,k,N", [(3, 8, 256), (4, 20, 128), (32, 5, 256),
                                   (5, 128, 128)])
def test_knn_topk_reference_matches_the_tpu_kernel(C, k, N):
    q, db = cloud(C, 2, 128, C), cloud(C + 1, 2, N, C)
    got = knn_topk(t(q), t(db), k)
    assert got.dtype == torch.int32 and got.shape == (2, 128, k)
    want = j_knn_topk(jnp.asarray(q), jnp.asarray(db), k, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        knn_topk_reference(t(q), t(db), k).numpy(), np.asarray(want))


@pytest.mark.parametrize("C", [3, 32])
def test_knn_topk_takes_any_query_count(C):
    """No M % 128 rule: 200 queries against the naive oracle."""
    q, db = cloud(40 + C, 2, 200, C), cloud(41 + C, 2, 150, C)
    got = knn_topk_reference(t(q), t(db), 11)
    want = knn_naive(jnp.asarray(db), jnp.asarray(q), 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,k", [(3, 4), (16, 4), (32, 10)])
def test_knn_gather_reference_matches_the_tpu_kernel(C, k):
    x = cloud(50 + C, 2, 128, C)
    idx, nbr = knn_gather(t(x), k)
    j_idx, j_nbr = j_knn_gather(jnp.asarray(x), k, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    exact = j_grouping(jnp.asarray(x), _neighbor_idx(jnp.asarray(x), k))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(exact))
    assert rel(nbr, j_nbr) <= 1e-4


def test_knn_gather_reference_takes_any_row_count():
    x = cloud(60, 2, 200, 12)
    idx, nbr = knn_gather_reference(t(x), 6)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(_neighbor_idx(jnp.asarray(x), 6)))
    np.testing.assert_array_equal(
        nbr.numpy(), np.asarray(j_grouping(jnp.asarray(x),
                                           _neighbor_idx(jnp.asarray(x), 6))))


@pytest.mark.parametrize("C,k", [(8, 3), (3, 6)])
def test_knn_gather_gradient_matches_jax(C, k):
    x = cloud(70 + C, 2, 128, C)
    xt = t(x).requires_grad_(True)
    (knn_gather(xt, k)[1] ** 2).sum().backward()
    want = jax.grad(lambda a: jnp.sum(
        j_grouping(a, _neighbor_idx(a, k)) ** 2))(jnp.asarray(x))
    assert rel(xt.grad, want) <= 1e-5
    want_tpu = jax.grad(lambda a: jnp.sum(
        j_knn_gather(a, k, True)[1] ** 2))(jnp.asarray(x))
    assert rel(xt.grad, want_tpu) <= 1e-3


def test_kernel_wrappers_check_their_inputs():
    x = torch.zeros(2, 16, 3)
    with pytest.raises(ValueError):
        knn_topk(x, x, 17)
    with pytest.raises(ValueError):
        knn_topk(x, torch.zeros(2, 16, 4), 3)
    with pytest.raises(ValueError):
        knn_topk(torch.zeros(2, 200, 3), torch.zeros(2, 200, 3), 129)
    with pytest.raises(TypeError):
        knn_topk(x.double(), x.double(), 3)
    with pytest.raises(ValueError):
        knn_gather(x, 16)
    with pytest.raises(ValueError):
        knn_gather(torch.zeros(2, 16), 3)
    assert _lib._lib is None


def _edge_conv_pair(fin, fout, k, seed):
    x = cloud(seed, 2, 64, fin)
    jm = JEdgeConv(fin=fin, fout=fout, k=k)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params, stats = perturb_bn(v["params"], v["batch_stats"],
                               np.random.RandomState(seed))
    params = jax.tree.map(np.asarray, params)
    m = EdgeConv(fin, fout, k)
    m.load_state_dict(edge_conv_state_from_jax(params, stats))
    return x, jm, params, stats, m


def test_edge_conv_converter_round_trip_is_exact():
    _, _, params, stats, m = _edge_conv_pair(8, 16, 6, 1)
    sd = m.state_dict()
    back = {"conv": {"dense": {
        "kernel": sd["conv.conv.weight"][:, :, 0, 0].T.numpy(),
        "bias": sd["conv.conv.bias"].numpy()}},
        "BatchNorm_0": {"bn": {"scale": sd["conv.bn.weight"].numpy(),
                               "bias": sd["conv.bn.bias"].numpy()}}}
    back_stats = {"BatchNorm_0": {"bn": {
        "mean": sd["conv.bn.running_mean"].numpy(),
        "var": sd["conv.bn.running_var"].numpy()}}}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(back_stats), jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)
    assert sd["conv.conv.weight"].shape == (16, 16, 1, 1)


@pytest.mark.parametrize("fin,fout,k", [(8, 16, 6), (3, 8, 4)])
def test_edge_conv_matches_flax(fin, fout, k):
    x, jm, params, stats, m = _edge_conv_pair(fin, fout, k, 2 + fin)
    ct = cloud(90, 2, 64, fout)

    def loss(p, a):
        y, upd = jm.apply({"params": p, "batch_stats": stats}, a,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(ct)), (y, upd)

    (_, (y_j, upd)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    y = m(xt)
    (y * t(ct)).sum().backward()
    assert y.shape == (2, 64, fout)
    assert rel(y, y_j) <= 1e-5
    assert rel(xt.grad, g_x) <= 1e-5
    bn = upd["batch_stats"]["BatchNorm_0"]["bn"]
    assert rel(m.conv.bn.running_mean, bn["mean"]) <= 1e-5
    assert rel(m.conv.bn.running_var, bn["var"]) <= 1e-5
    w = m.conv.conv.weight.grad[:, :, 0, 0].T
    assert rel(w, g_p["conv"]["dense"]["kernel"]) <= 1e-5
    # the conv bias's gradient is 0 in exact arithmetic (batch norm takes
    # out a per-channel shift): both are rounding noise, held in absolute
    # terms to 1e-5 of the largest weight gradient
    assert float((m.conv.conv.bias.grad - t(g_p["conv"]["dense"]["bias"]))
                 .abs().max()) <= 1e-5 * float(w.abs().max())
    assert rel(m.conv.bn.weight.grad,
               g_p["BatchNorm_0"]["bn"]["scale"]) <= 1e-5
    assert rel(m.conv.bn.bias.grad, g_p["BatchNorm_0"]["bn"]["bias"]) <= 1e-5
