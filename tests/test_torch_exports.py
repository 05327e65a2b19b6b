"""The port's public surface against the JAX package's.

* Each subpackage's ``__all__`` (``losses``, ``models``, ``train``,
  ``utils``, ``native``) covers the JAX subpackage's public names, less the
  absences listed with their reasons in ``pdgn_tpu_torch.train.NOT_PORTED``,
  and every name resolves (``from pdgn_tpu_torch.losses import chamfer_cd``
  works as it does in ``pdgn_tpu``).
* ``compute_mean_covariance`` within rel 1e-6 of JAX's on a seeded
  (2, 64, 20, 3).
* ``shape_preserving_loss`` within rel 1e-5 of JAX's at the v1 (1, 5) and
  v2 (1, 1) weights on four small clouds on which both packages build the
  same neighbourhoods.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel, t

from pdgn_tpu.losses import compute_mean_covariance as jax_mean_cov
from pdgn_tpu.losses import shape_preserving_loss as jax_shape_loss
from pdgn_tpu_torch.losses import (compute_mean_covariance,
                                   shape_preserving_loss)
from pdgn_tpu_torch.ops.kernels.local_stats import knn_direct
from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist
from pdgn_tpu_torch.train import NOT_PORTED

NATIVE = ("approxmatch_cpu", "available", "fps_cpu", "knnquery_cpu",
          "nndistance_cpu")


def _public(package: str):
    mod = importlib.import_module(package)
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return set(NATIVE)   # pdgn_tpu.native has no __all__


@pytest.mark.parametrize("sub", ["losses", "models", "train", "utils",
                                 "native"])
def test_all_covers_jax(sub):
    want = _public(f"pdgn_tpu.{sub}")
    port = importlib.import_module(f"pdgn_tpu_torch.{sub}")
    absent = set(NOT_PORTED) if sub == "train" else set()
    assert absent <= want
    assert want - absent <= set(port.__all__), sorted(want - absent
                                                     - set(port.__all__))
    assert not absent & set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
        assert not isinstance(getattr(port, name), type(importlib)), name


def test_compute_mean_covariance_matches_jax():
    grouped = np.random.RandomState(64).randn(2, 64, 20, 3).astype(
        np.float32)
    mu_w, cov_w = jax_mean_cov(jnp.asarray(grouped))
    mu, cov = compute_mean_covariance(t(grouped))
    assert mu.shape == (2, 64, 3) and cov.shape == (2, 64, 3, 3)
    assert rel(mu, mu_w) <= 1e-6 and rel(cov, cov_w) <= 1e-6


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.RandomState(65)
    out = [(rng.randn(2, n, 3) * 0.5).astype(np.float32)
           for n in (32, 64, 128, 256)]
    # the JAX CPU path selects neighbours on expansion distances, the port
    # on direct differences: the sets must agree on these clouds
    for i in range(3):
        for j in range(i, 4):
            a, c = t(out[j]), t(out[i])
            want = torch.topk(pairwise_sqdist(c, a), 20, largest=False,
                              sorted=True).indices
            assert torch.equal(torch.sort(knn_direct(a, c, 20).long(),
                                          -1).values,
                               torch.sort(want, -1).values)
    return out


@pytest.mark.parametrize("weights", [(1.0, 5.0), (1.0, 1.0)],
                         ids=["v1", "v2"])
def test_shape_preserving_loss_matches_jax(clouds, weights):
    mu_w, cov_w = weights
    want = jax_shape_loss([jnp.asarray(c) for c in clouds], 20,
                          mu_weight=mu_w, cov_weight=cov_w)
    got = shape_preserving_loss([t(c) for c in clouds], 20, mu_weight=mu_w,
                                cov_weight=cov_w)
    assert got.shape == () and rel(got, want) <= 1e-5
