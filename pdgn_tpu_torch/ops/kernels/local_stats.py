"""Local neighbourhood mean and covariance (port of
pdgn_tpu/ops/pallas/local_stats.py), the core of the shape-preserving loss.

:func:`local_mean_cov` is a ``torch.autograd.Function``. Its forward keeps
the TPU kernel's residual, two words a center: ``theta``, the distance of
the k-th selected point, and ``tie``, that point's index. The selected set
is exactly ``d < theta | (d == theta & j <= tie)``, so the backward rebuilds
it from them instead of k saved indices. CUDA tensors launch
``csrc/local_stats.cu`` for the forward (``knn_select``'s kNN, a warp a
center, then the moments and the residual) and for the backward (a block of
source points walks every center of its cloud and tests the residual). CPU
tensors run the plain versions: :func:`knn_direct` + :func:`stats_given_idx`
+ :func:`residual_plain` forward, :func:`bwd_mask_plain` backward.
:func:`bwd_plain`, autograd's VJP of :func:`stats_given_idx`, is the
independent check of both backwards. Centers get no gradient: they only
steer the graph.
"""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.knn import topk_ascending_idx

# the kernel's limits: knn_select's longest list, and the JAX kernel's own
# N <= 0x10000 (local_stats_ok)
MAX_K = 128
MAX_POINTS = 0x10000


def _sq3(diff: torch.Tensor):
    """``((dx*dx + dy*dy) + dz*dz)`` over the last axis, each step rounded
    on its own, as the kernels' ``direct_dist`` rounds it."""
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def direct_sqdist(src: torch.Tensor, centers: torch.Tensor):
    """``(B, M, N)`` fp32 direct distances from each center to each
    point."""
    return _sq3(centers[:, :, None, :] - src[:, None, :, :])


def knn_direct(src: torch.Tensor, centers: torch.Tensor, k: int):
    """``(B, M, k)`` int32: the k nearest points of ``src`` to each center,
    by :func:`direct_sqdist`, ascending, lowest index first (the center
    itself is included when it is a point of src)."""
    return topk_ascending_idx(direct_sqdist(src, centers), k)


def residual_plain(src: torch.Tensor, centers: torch.Tensor,
                   idx: torch.Tensor):
    """The selection's residual from ``knn_direct``'s ``idx``: ``theta (B,
    M)`` fp32, the direct distance from each center to its k-th point, and
    ``tie (B, M)`` int32, that point's index."""
    tie = idx[..., -1]
    y = torch.gather(src, 1, tie.long()[..., None].expand(-1, -1, 3))
    return _sq3(centers - y), tie.to(torch.int32)


def selection_mask(src, centers, theta, tie):
    """``(B, M, N)`` bool: the set the residual selects, ``d < theta | (d ==
    theta & j <= tie)``, with ``d`` from :func:`direct_sqdist`."""
    d = direct_sqdist(src, centers)
    j = torch.arange(src.shape[1], device=src.device)
    th, ti = theta[..., None], tie[..., None]
    return (d < th) | ((d == th) & (j <= ti))


def compute_mean_covariance(grouped: torch.Tensor):
    """``grouped (B, M, K, 3)`` -> ``mu (B, M, 3)``, ``cov (B, M, 3, 3)``,
    the biased ``1/K`` covariance (port of
    pdgn_tpu/losses/shape_preserving.py::compute_mean_covariance)."""
    K = grouped.shape[2]
    mu = grouped.mean(dim=2)
    d = grouped - mu[:, :, None, :]
    return mu, torch.einsum("bmki,bmkj->bmij", d, d) / float(K)


def stats_given_idx(src: torch.Tensor, idx: torch.Tensor):
    """Gather + :func:`compute_mean_covariance` (port of ``_reference``):
    ``mu (B, M, 3)`` and ``cov (B, M, 9)`` row-major."""
    mu, cov = compute_mean_covariance(grouping(src, idx))
    return mu, cov.reshape(*mu.shape[:2], 9)


def fwd_kernel(src, centers, k: int):
    """Launch the forward of ``csrc/local_stats.cu``: idx, theta, tie, mu,
    cov."""
    B, N, _ = src.shape
    M = centers.shape[1]
    dev = src.device
    idx = torch.empty(B, M, k, device=dev, dtype=torch.int32)
    theta = torch.empty(B, M, device=dev, dtype=torch.float32)
    tie = torch.empty(B, M, device=dev, dtype=torch.int32)
    mu = torch.empty(B, M, 3, device=dev, dtype=torch.float32)
    cov = torch.empty(B, M, 9, device=dev, dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_local_stats_fwd(
        p(src), p(centers), B, N, M, k, p(idx), p(theta), p(tie), p(mu),
        p(cov), _lib.stream_handle(dev)), "pdgn_local_stats_fwd")
    _lib.LAUNCHES["local_stats_fwd"] += 1
    return idx, theta, tie, mu, cov


def bwd_kernel(src, centers, theta, tie, mu, g_mu, g_cov, k: int):
    """Launch the backward of ``csrc/local_stats.cu``: d_src."""
    B, N, _ = src.shape
    M = centers.shape[1]
    d_src = torch.empty_like(src)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_local_stats_bwd(
        p(src), p(centers), p(theta), p(tie), p(mu), p(g_mu), p(g_cov), B,
        N, M, k, p(d_src), _lib.stream_handle(src.device)),
        "pdgn_local_stats_bwd")
    _lib.LAUNCHES["local_stats_bwd"] += 1
    return d_src


def bwd_mask_plain(src, centers, theta, tie, mu, g_mu, g_cov, k: int):
    """The plain backward from the residual (the TPU kernel's math): the
    mask of :func:`selection_mask`, then ``d_src = S_alpha + S_G y`` with
    the per-center rows ``[alpha | G]``, ``G = (g_cov + g_cov^T)/k``,
    ``alpha = g_mu/k - G mu``, summed over the centers that select each
    point."""
    oh = selection_mask(src, centers, theta, tie).to(src.dtype)
    G = (g_cov + g_cov.reshape(*g_cov.shape[:2], 3, 3).transpose(-1, -2)
         .reshape(g_cov.shape)) / k                      # (B, M, 9)
    alpha = g_mu / k - torch.einsum(
        "bmij,bmj->bmi", G.reshape(*G.shape[:2], 3, 3), mu)
    acc = torch.einsum("bmn,bmf->bnf", oh, torch.cat([alpha, G], -1))
    s_g = acc[..., 3:].reshape(*acc.shape[:2], 3, 3)
    return acc[..., :3] + torch.einsum("bnij,bnj->bni", s_g, src)


def bwd_plain(src, idx, g_mu, g_cov):
    """The plain backward given the indices: autograd's VJP of
    :func:`stats_given_idx`."""
    with torch.enable_grad():
        s = src.detach().requires_grad_(True)
        mu, cov = stats_given_idx(s, idx.long())
        (d_src,) = torch.autograd.grad((mu, cov), (s,), (g_mu, g_cov))
    return d_src


class _LocalStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, src, centers, k):
        if src.device.type == "cuda":
            _, theta, tie, mu, cov = fwd_kernel(src, centers, k)
        else:
            idx = knn_direct(src, centers, k)
            mu, cov = stats_given_idx(src, idx)
            theta, tie = residual_plain(src, centers, idx)
        ctx.save_for_backward(src, centers, theta, tie, mu)
        ctx.k = k
        return mu, cov

    @staticmethod
    def backward(ctx, g_mu, g_cov):
        src, centers, theta, tie, mu = ctx.saved_tensors
        g_mu, g_cov = g_mu.contiguous(), g_cov.contiguous()
        if src.device.type == "cuda":
            d_src = bwd_kernel(src, centers, theta, tie, mu, g_mu, g_cov,
                               ctx.k)
        else:
            d_src = bwd_mask_plain(src, centers, theta, tie, mu, g_mu, g_cov,
                                   ctx.k)
        return d_src, None, None


def local_mean_cov(src: torch.Tensor, centers: torch.Tensor, k: int = 20):
    """Mean ``(B, M, 3)`` and covariance ``(B, M, 9)`` of each center's
    k-neighbourhood in ``src`` (k-NN includes the center when it is a point
    of ``src``). CUDA tensors launch the kernels, CPU tensors run the plain
    versions (float32, or float64: an arbiter's dtype); anything else
    raises."""
    if src.dim() != 3 or centers.dim() != 3 or src.shape[-1] != 3 \
            or centers.shape[-1] != 3 or src.shape[0] != centers.shape[0]:
        raise ValueError(f"local_mean_cov: need src (B,N,3), centers (B,M,3); "
                         f"got {tuple(src.shape)}, {tuple(centers.shape)}")
    cpu64 = src.device.type == "cpu" and src.dtype == torch.float64
    for name, t in (("src", src), ("centers", centers)):
        if t.dtype != (torch.float64 if cpu64 else torch.float32):
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
    if src.shape[1] < k:
        raise ValueError(f"local_mean_cov: {src.shape[1]} points < k={k}")
    src, centers = src.contiguous(), centers.contiguous()
    if src.device.type == "cuda":
        B, N, M = src.shape[0], src.shape[1], centers.shape[1]
        if not 1 <= k <= MAX_K or N > MAX_POINTS:
            raise ValueError(f"local_stats kernel: needs 1 <= k <= MAX_K="
                             f"{MAX_K} and N <= MAX_POINTS={MAX_POINTS}, got "
                             f"k={k}, N={N}")
        if B * M * k >= 2 ** 31:
            raise ValueError(f"local_stats kernel: B*M*k = {B * M * k} "
                             f"neighbour entries exceed int32; use a smaller "
                             f"batch")
        _lib.check_rows(B, 1, "local_stats")
    elif src.device.type != "cpu":
        raise ValueError(f"local_mean_cov: unsupported device {src.device}")
    return _LocalStats.apply(src, centers.detach(), k)
