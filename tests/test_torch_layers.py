"""The port's layers against pdgn_tpu.models.layers on the same numpy
weights and inputs: rel <= 1e-6 (fp32, same arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel, t

from pdgn_tpu.models import layers as jl
from pdgn_tpu_torch.models import layers as tl

TOL = 1e-6


def test_torch_dense_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 12).astype(np.float32)
    layer = tl.TorchDense(12, 5, (1,))
    want = jl.TorchDense(5).apply(
        {"params": {"dense": {"kernel": layer.kernel.detach().numpy(),
                              "bias": layer.bias.detach().numpy()}}},
        jnp.asarray(x))
    with torch.no_grad():
        got = layer(t(x))
    assert rel(got, want) <= TOL
    # torch default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    assert float(layer.weight.detach().abs().max()) <= 1 / np.sqrt(12)


def test_batchnorm_output_and_running_stats_match_flax():
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 9, 6) * 2 + 1).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(6)).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    mean0 = rng.randn(6).astype(np.float32)
    var0 = (rng.rand(6) + 0.5).astype(np.float32)
    want, new = jl.BatchNorm().apply(
        {"params": {"bn": {"scale": scale, "bias": bias}},
         "batch_stats": {"bn": {"mean": mean0, "var": var0}}},
        jnp.asarray(x), mutable=["batch_stats"])
    bn = tl.BatchNorm(6)
    bn.load_state_dict({"weight": t(scale), "bias": t(bias),
                        "running_mean": t(mean0), "running_var": t(var0),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    with torch.no_grad():
        got = bn(t(x))
    assert rel(got, want) <= TOL
    assert rel(bn.running_mean, new["batch_stats"]["bn"]["mean"]) <= TOL
    assert rel(bn.running_var, new["batch_stats"]["bn"]["var"]) <= TOL
    assert int(bn.num_batches_tracked) == 1
    # eval mode: still batch statistics, running averages frozen
    bn.eval()
    before = bn.running_mean.clone()
    with torch.no_grad():
        again = bn(t(x))
    assert rel(again, want) <= TOL
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("permuted", [False, True])
def test_batchnorm_fold_matches_flax(permuted):
    rng = np.random.RandomState(2)
    n = 8
    mean = rng.randn(n).astype(np.float32)
    var = (rng.rand(n) + 0.1).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(n)).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    r_mean = rng.randn(n).astype(np.float32)
    r_var = (rng.rand(n) + 0.5).astype(np.float32)
    perm = np.array([2 * (p % 4) + p // 4 for p in range(n)])
    # flax holds every tensor in the statistics' (block) order
    p = perm if permuted else np.arange(n)
    out, new = jl.BatchNormFold().apply(
        {"params": {"bn": {"scale": scale[p], "bias": bias[p]}},
         "batch_stats": {"bn": {"mean": r_mean[p], "var": r_var[p]}}},
        jnp.asarray(mean), jnp.asarray(var), mutable=["batch_stats"])
    fold = tl.BatchNormFold(n)
    fold.load_state_dict({"weight": t(scale), "bias": t(bias),
                          "running_mean": t(r_mean), "running_var": t(r_var),
                          "num_batches_tracked": torch.tensor(0)})
    fold.train()
    got = fold.fold(t(mean), t(var), t(perm) if permuted else None)
    for g, w in zip(got, out):
        assert rel(g, w) <= TOL
    assert rel(fold.running_mean[p], new["batch_stats"]["bn"]["mean"]) <= TOL
    assert rel(fold.running_var[p], new["batch_stats"]["bn"]["var"]) <= TOL


def test_mlp_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 10).astype(np.float32)
    mlp = tl.MLP(10, (16, 8, 3))
    dense = [m for m in mlp if isinstance(m, tl.TorchDense)]
    params = {f"TorchDense_{i}": {"dense": {
        "kernel": d.kernel.detach().numpy(), "bias": d.bias.detach().numpy()}}
        for i, d in enumerate(dense)}
    want = jl.MLP((16, 8, 3)).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mlp(t(x))
    assert rel(got, want) <= TOL
    assert [k for k in mlp.state_dict()] == [
        "0.weight", "0.bias", "2.weight", "2.bias", "4.weight", "4.bias"]


def test_leaky_relu_slope():
    x = torch.tensor([-2.0, 0.0, 3.0])
    assert torch.equal(tl.leaky_relu(x), torch.tensor([-0.02, 0.0, 3.0]))


@pytest.mark.parametrize("negative_slope", [None, 0.2])
def test_dense_dbr_matches_flax(negative_slope):
    """Dense + Dropout + BN + activation: deterministic (eval) output equal
    to flax's; in training with drop rate 0 the running statistics move as
    flax's do; in training at rate 0.5 about half the pre-BN units drop."""
    rng = np.random.RandomState(4)
    x = rng.randn(6, 5).astype(np.float32)
    layer = tl.DenseDBR(5, 8, drop_rate=0.0, negative_slope=negative_slope)
    scale = (1 + 0.3 * rng.randn(8)).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    with torch.no_grad():
        layer[2].weight.copy_(t(scale))
        layer[2].bias.copy_(t(bias))
    variables = {
        "params": {"TorchDense_0": {"dense": {
            "kernel": layer[0].kernel.detach().numpy(),
            "bias": layer[0].bias.detach().numpy()}},
            "BatchNorm_0": {"bn": {"scale": scale, "bias": bias}}},
        "batch_stats": {"BatchNorm_0": {"bn": {
            "mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}}}
    module = jl.DenseDBR(8, drop_rate=0.0, negative_slope=negative_slope)
    want, new = module.apply(variables, jnp.asarray(x), deterministic=True,
                             mutable=["batch_stats"])
    layer.train()
    with torch.no_grad():
        got = layer(t(x))
    assert rel(got, want) <= TOL
    bn = new["batch_stats"]["BatchNorm_0"]["bn"]
    assert rel(layer[2].running_mean, bn["mean"]) <= TOL
    assert rel(layer[2].running_var, bn["var"]) <= TOL
    dropped = tl.DenseDBR(5, 4000, drop_rate=0.5)
    with torch.no_grad():
        h = dropped[1](dropped[0](t(x)))
    assert 0.45 < float((h == 0).float().mean()) < 0.55
