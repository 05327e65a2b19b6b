"""The local-statistics residual on the CPU: the port's plain versions
against the JAX package's Pallas kernels in interpret mode, on numpy inputs
from a seed (B=2, M=128, N=256, k=20; ``_tie_case`` cuts an integer-lattice
shell mid-way).

The forward keeps two words a center, ``theta`` (the k-th distance) and
``tie`` (the k-th point's index); the backward rebuilds the selection as
``d < theta | (d == theta & j <= tie)``.

XLA's jitted CPU code contracts the Pallas kernel's distance into FMAs,
``fma(e2, e2, fma(e0, e0, e1 * e1))`` (every bit of JAX's ``theta`` equals
that expression at JAX's ``tie``), where the port rounds every product
and sum, as its CUDA kernels do. So JAX's ``theta`` lies within 2 ulp of
the port's, ``tie`` is equal, and each backward rebuilds its mask from its
own residual: JAX's ``theta`` against the port's distances drops the k-th
point of a few centers. Tolerances: ``bwd_mask_plain`` rel <= 1e-5 of
JAX's ``_bwd_pallas`` and of ``bwd_plain`` (autograd through the gather).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_kernels import _local_case, _tie_case
from torch_port_util import rel, t

from pdgn_tpu.ops.pallas.local_stats import _bwd_pallas, _fwd_pallas
from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_mask_plain,
                                                    bwd_plain, knn_direct,
                                                    local_mean_cov,
                                                    residual_plain,
                                                    selection_mask,
                                                    stats_given_idx)

K = 20
CASES = ["random", "self", "ties"]


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs, cotangents and JAX's residual, mu and d_src of one case."""
    if name == "ties":
        src, centers = _tie_case()
    else:
        src, centers = _local_case(21)
        if name == "self":
            src = centers
    rng = np.random.RandomState(23)
    g_mu = rng.randn(*centers.shape).astype(np.float32)
    g_cov = rng.randn(centers.shape[0], centers.shape[1], 9).astype(
        np.float32)
    s, c = jnp.asarray(src), jnp.asarray(centers)
    theta, tie, mu, _ = _fwd_pallas(s, c, K, True, "radix")
    d_src = _bwd_pallas(s, c, theta, tie, mu, jnp.asarray(g_mu),
                        jnp.asarray(g_cov), K, True)
    return dict(src=t(src), centers=t(centers), g_mu=t(g_mu),
                g_cov=t(g_cov), theta=t(theta)[..., 0], tie=t(tie)[..., 0],
                mu=t(mu), d_src=t(d_src))


def _port(name):
    """The port's selection, residual and mu on one case."""
    c = _case(name)
    idx = knn_direct(c["src"], c["centers"], K)
    theta, tie = residual_plain(c["src"], c["centers"], idx)
    mu, _ = stats_given_idx(c["src"], idx)
    return idx, theta, tie, mu


@pytest.mark.parametrize("case", CASES)
def test_residual_matches_pallas_interpret(case):
    """``tie`` equal to JAX's; ``theta`` within 2 ulp (XLA's contracted
    distance), and JAX's ``theta`` bit-equal to the contracted expression
    at the same point, so the gap is that rounding and no other."""
    c = _case(case)
    _, theta, tie, _ = _port(case)
    assert theta.dtype == torch.float32 and tie.dtype == torch.int32
    assert torch.equal(tie, c["tie"])
    ulps = (theta.view(torch.int32).long()
            - c["theta"].view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 2
    y = torch.gather(c["src"], 1, tie.long()[..., None].expand(-1, -1, 3))
    e = (c["centers"] - y).double()          # exact fp32 differences
    sq1 = (e[..., 1] * e[..., 1]).float().double()
    inner = (e[..., 0] * e[..., 0] + sq1).float().double()  # fma(e0, e0, .)
    contracted = (e[..., 2] * e[..., 2] + inner).float()
    assert torch.equal(contracted, c["theta"])


@pytest.mark.parametrize("case", CASES)
def test_mask_backward_matches_pallas_interpret(case):
    """``bwd_mask_plain`` on the port's residual (JAX's ``tie``, the port's
    ``theta``) rel <= 1e-5 of JAX's ``_bwd_pallas`` on JAX's residual."""
    c = _case(case)
    _, theta, tie, mu = _port(case)
    got = bwd_mask_plain(c["src"], c["centers"], theta, tie, mu, c["g_mu"],
                         c["g_cov"], K)
    assert got.shape == c["src"].shape
    assert rel(got, c["d_src"]) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_residual_rebuilds_the_selection(case):
    """The rebuilt mask is ``knn_direct``'s set, k points a center, ties
    included."""
    c = _case(case)
    idx, theta, tie, _ = _port(case)
    mask = selection_mask(c["src"], c["centers"], theta, tie)
    want = torch.zeros_like(mask).scatter_(-1, idx.long(), True)
    assert bool((mask.sum(-1) == K).all())
    assert torch.equal(mask, want)


@pytest.mark.parametrize("case", CASES)
def test_mask_backward_matches_gather_vjp(case):
    """``bwd_mask_plain`` rel <= 1e-5 of ``bwd_plain``, autograd's VJP of
    the gather and moments on the same selection."""
    c = _case(case)
    idx, theta, tie, mu = _port(case)
    got = bwd_mask_plain(c["src"], c["centers"], theta, tie, mu, c["g_mu"],
                         c["g_cov"], K)
    assert rel(got, bwd_plain(c["src"], idx, c["g_mu"], c["g_cov"])) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_cpu_autograd_saves_the_residual_not_the_indices(case):
    """The CPU ``_LocalStats`` keeps (src, centers, theta, tie, mu): two
    words a center, no (B, M, k) index table; its gradient is
    ``bwd_mask_plain``'s on the port's residual."""
    c = _case(case)
    s = c["src"].clone().requires_grad_(True)
    mu, cov = local_mean_cov(s, c["centers"], K)
    B, N, M = s.shape[0], s.shape[1], c["centers"].shape[1]
    saved = mu.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved] == [(B, N, 3), (B, M, 3), (B, M),
                                               (B, M), (B, M, 3)]
    assert all(x.shape[-1] != K for x in saved)
    (d_src,) = torch.autograd.grad((mu, cov), (s,), (c["g_mu"], c["g_cov"]))
    _, theta, tie, mu_p = _port(case)
    assert torch.equal(d_src, bwd_mask_plain(
        c["src"], c["centers"], theta, tie, mu_p, c["g_mu"], c["g_cov"], K))
