"""Local neighbourhood mean and covariance (port of
pdgn_tpu/ops/pallas/local_stats.py), the core of the shape-preserving loss.

:func:`local_mean_cov` is a ``torch.autograd.Function``. CUDA tensors
launch ``csrc/local_stats.cu`` for the forward (``knn_select``'s kNN, a warp
a center, then the moments; the k indices saved) and for the backward (a
gather over the reverse adjacency of those indices). CPU tensors run the
plain versions: :func:`knn_direct` + :func:`stats_given_idx` forward, and
the autograd VJP of :func:`stats_given_idx` backward. Centers get no
gradient: they only steer the graph.
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


def knn_direct(src: torch.Tensor, centers: torch.Tensor, k: int):
    """``(B, M, k)`` int32: the k nearest points of ``src`` to each center,
    fp32 direct differences ``((dx*dx + dy*dy) + dz*dz)``, ascending, lowest
    index first (the center itself is included when it is a point of src)."""
    diff = centers[:, :, None, :] - src[:, None, :, :]    # (B, M, N, 3)
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return topk_ascending_idx(d, k)


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
    """Launch the forward of ``csrc/local_stats.cu``: idx, mu, cov."""
    B, N, _ = src.shape
    M = centers.shape[1]
    dev = src.device
    idx = torch.empty(B, M, k, device=dev, dtype=torch.int32)
    mu = torch.empty(B, M, 3, device=dev, dtype=torch.float32)
    cov = torch.empty(B, M, 9, device=dev, dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_local_stats_fwd(
        p(src), p(centers), B, N, M, k, p(idx), p(mu), p(cov),
        _lib.stream_handle(dev)), "pdgn_local_stats_fwd")
    _lib.LAUNCHES["local_stats_fwd"] += 1
    return idx, mu, cov


def bwd_kernel(src, idx, mu, g_mu, g_cov):
    """Launch the backward of ``csrc/local_stats.cu``: d_src."""
    B, N, _ = src.shape
    M, k = idx.shape[1], idx.shape[2]
    dev = src.device
    i32 = dict(device=dev, dtype=torch.int32)
    count = torch.empty(B * N, **i32)
    cursor = torch.empty(B * N, **i32)
    offsets = torch.empty(B * N + 1, **i32)
    entries = torch.empty(B * M * k, **i32)
    d_src = torch.empty_like(src)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_local_stats_bwd(
        p(src), p(idx), p(mu), p(g_mu), p(g_cov), B, N, M, k, p(count),
        p(cursor), p(offsets), p(entries), p(d_src),
        _lib.stream_handle(dev)), "pdgn_local_stats_bwd")
    _lib.LAUNCHES["local_stats_bwd"] += 1
    return d_src


def bwd_plain(src, idx, g_mu, g_cov):
    """The plain backward: autograd's VJP of :func:`stats_given_idx`."""
    with torch.enable_grad():
        s = src.detach().requires_grad_(True)
        mu, cov = stats_given_idx(s, idx.long())
        (d_src,) = torch.autograd.grad((mu, cov), (s,), (g_mu, g_cov))
    return d_src


class _LocalStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, src, centers, k):
        if src.device.type == "cuda":
            idx, mu, cov = fwd_kernel(src, centers, k)
        else:
            idx = knn_direct(src, centers, k)
            mu, cov = stats_given_idx(src, idx)
        ctx.save_for_backward(src, idx, mu)
        return mu, cov

    @staticmethod
    def backward(ctx, g_mu, g_cov):
        src, idx, mu = ctx.saved_tensors
        g_mu, g_cov = g_mu.contiguous(), g_cov.contiguous()
        if src.device.type == "cuda":
            d_src = bwd_kernel(src, idx, mu, g_mu, g_cov)
        else:
            d_src = bwd_plain(src, idx, g_mu, g_cov)
        return d_src, None, None


def local_mean_cov(src: torch.Tensor, centers: torch.Tensor, k: int = 20):
    """Mean ``(B, M, 3)`` and covariance ``(B, M, 9)`` of each center's
    k-neighbourhood in ``src`` (k-NN includes the center when it is a point
    of ``src``). CUDA tensors launch the kernels, CPU tensors run the plain
    versions; anything else raises."""
    if src.dim() != 3 or centers.dim() != 3 or src.shape[-1] != 3 \
            or centers.shape[-1] != 3 or src.shape[0] != centers.shape[0]:
        raise ValueError(f"local_mean_cov: need src (B,N,3), centers (B,M,3); "
                         f"got {tuple(src.shape)}, {tuple(centers.shape)}")
    for name, t in (("src", src), ("centers", centers)):
        if t.dtype != torch.float32:
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
