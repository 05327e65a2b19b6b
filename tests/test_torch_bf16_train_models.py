"""The port's discriminators with ``dtype=torch.bfloat16``
(``--d_compute_dtype bfloat16``) against the JAX package's with
``dtype="bfloat16"``, on the same weights (the port's seeded ones with
random batch-norm parameters, carried to JAX by
``pdgn_tpu.convert_ckpt.convert_discriminator``) and the same fp32 clouds.

JAX's bf16 conv stack takes its BN statistics by two definitions
(pdgn_tpu/models/layers.py:443-505): a layer whose input is at most 128
wide (every ``DenseBR`` of the four discriminators) from the fp32 moments
of its input through the linear identity (``linear_bn_stats``), the
statistics of the unrounded product; the pooled last layer
(``DenseBRPool``) from the upcast of its bf16 output. In fp32 the two are
one; in bf16 they differ by the output's rounding, so the port takes them
as JAX does (``layers.dense_br``, ``layers.dense_br_pool``). JAX is jitted
with XLA's excess precision off (tests/test_torch_bf16_generator.py says
why).

B=4 clouds of 256/512/1024/2048 points, one forward in training mode.
Measured over two seeds of each discriminator: logits rel <= 8.0e-3 of
the largest (the two sides sum in other orders, so a value at a bf16
midpoint rounds the other way and can move a pooled maximum), running
statistics rel <= 1.02e-5 per tensor. Limits: logits 2e-2, running
statistics 1e-4. The running statistics follow the linear identity in
the narrow layers: D1's first layer moves its running mean by that mean
(rel 1e-6), which differs from the mean of its rounded output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (one_torch_thread, perturbed_state, rel,  # noqa: F401
                             t)

import pdgn_tpu.models.discriminator as jdisc
from pdgn_tpu.convert_ckpt import convert_discriminator
from pdgn_tpu_torch.convert_ckpt import discriminator_state_from_jax
from pdgn_tpu_torch.models import discriminator as tdisc
from pdgn_tpu_torch.models.layers import linear_bn_stats

B = 4
SIZES = (256, 512, 1024, 2048)
BF = torch.bfloat16


def _model(i, seed):
    """A seeded bf16 port discriminator with random BN parameters and
    running statistics."""
    m = getattr(tdisc, f"PointDiscriminator{i}")(BF)
    m.load_state_dict(perturbed_state(m, seed))
    return m


def _jax_forward(module, variables, x):
    fn = jax.jit(lambda v, x: module.apply(v, x, mutable=["batch_stats"]))
    return fn.lower(variables, x).compile(
        compiler_options={"xla_allow_excess_precision": False})(variables, x)


@pytest.mark.parametrize("i", [1, 2, 3, 4])
def test_bf16_discriminator_matches_jax(i):
    """Logits and the running statistics after one training forward."""
    m = _model(i, 10 + i)
    x = (np.random.RandomState(i).randn(B, SIZES[i - 1], 3) * 0.5
         ).astype(np.float32)
    # copies: JAX may alias a numpy buffer, and the port's forward moves
    # its running statistics in place
    v, _ = convert_discriminator({k: a.numpy().copy()
                                  for k, a in m.state_dict().items()})
    v = jax.tree.map(jnp.asarray, v)
    module = getattr(jdisc, f"PointDiscriminator{i}")(dtype="bfloat16")
    want, upd = jax.block_until_ready(_jax_forward(module, v,
                                                   jnp.asarray(x)))
    m.train()
    got = m(t(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(got, want) <= 2e-2, rel(got, want)
    want_sd = discriminator_state_from_jax(
        jax.tree.map(np.asarray, v["params"]),
        jax.tree.map(np.asarray, upd["batch_stats"]))
    for key, a in m.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert rel(a, want_sd[key]) <= 1e-4, (key, rel(a, want_sd[key]))
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_narrow_layers_take_the_linear_identity_statistics():
    """D1's first layer: its running mean moves by the linear identity's
    mean of the fp32 input, which is not the mean of the bf16-rounded
    output (the fp32 definition over y)."""
    m = _model(1, 3)
    x = t((np.random.RandomState(8).randn(B, 256, 3) * 0.5)
          .astype(np.float32))
    dense, bn = m.fc1[0], m.fc1[1]
    before = bn.running_mean.clone()
    m.train()
    with torch.no_grad():
        m(x)
        mean, _ = linear_bn_stats(x, dense.kernel, dense.bias)
        y_mean = dense(x).float().reshape(-1, 64).mean(dim=0)
    moved = bn.running_mean - 0.9 * before
    assert rel(moved, 0.1 * mean) <= 1e-6
    assert rel(0.1 * y_mean, 0.1 * mean) > 1e-4
