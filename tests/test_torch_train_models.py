"""The port's discriminators against the JAX package's, on the same weights
(carried by ``discriminator_state_from_jax``, BN parameters and statistics
perturbed) and the same numpy clouds: logits and updated running statistics
rel <= 1e-5 (fp32; the JAX block takes narrow layers' BN statistics through
the second-moment identity, the port over the activation itself). Also the
reference module names and the weight carrier's round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import perturb_bn, rel, t

import pdgn_tpu.models.discriminator as jdisc
from pdgn_tpu.convert_ckpt import convert_discriminator
from pdgn_tpu.convert_ckpt import discriminator_rules as jax_rules
from pdgn_tpu_torch.convert_ckpt import discriminator_state_from_jax
from pdgn_tpu_torch.models import discriminator as tdisc

SIZES = (32, 64, 128, 256)
B = 4


def _pair(i):
    jm = getattr(jdisc, f"PointDiscriminator{i}")()
    v = jm.init(jax.random.PRNGKey(i), jnp.zeros((2, SIZES[i - 1], 3)))
    params, stats = perturb_bn(v["params"], v["batch_stats"],
                               np.random.RandomState(10 + i))
    tm = getattr(tdisc, f"PointDiscriminator{i}")()
    tm.load_state_dict(discriminator_state_from_jax(params, stats))
    return jm, params, stats, tm


@pytest.mark.parametrize("i", [1, 2, 3, 4])
def test_discriminator_matches_jax(i):
    jm, params, stats, tm = _pair(i)
    x = np.random.RandomState(20 + i).randn(B, SIZES[i - 1], 3).astype(
        np.float32)
    want, new = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(t(x))
    assert got.shape == (B, 1)
    assert rel(got, want) <= 1e-5
    want_sd = discriminator_state_from_jax(params, new["batch_stats"])
    for key, v in tm.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert rel(v, want_sd[key]) <= 1e-5, key


@pytest.mark.parametrize("i", [1, 2, 3, 4])
def test_discriminator_names_and_carrier_round_trip(i):
    """Reference torch names (the JAX converter's rules accept the port's
    state dict) and an exact round trip through the JAX converter."""
    _, params, stats, tm = _pair(i)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    want = {prefix for prefix, _, _ in jax_rules(sd)}
    got = {k.rsplit(".", 1)[0] for k in sd}
    assert got == want
    back, _ = convert_discriminator(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back["params"]
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_full_width_discriminator_parameter_counts_match_jax():
    for i in range(1, 5):
        jm = getattr(jdisc, f"PointDiscriminator{i}")()
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 3)))["params"]
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        got = sum(p.numel() for p in
                  getattr(tdisc, f"PointDiscriminator{i}")().parameters())
        assert got == want, i
