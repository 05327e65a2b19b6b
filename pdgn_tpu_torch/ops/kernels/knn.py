"""Exact kNN selection, alone and fused with the neighbour gather (port of
pdgn_tpu/ops/pallas/knn.py::knn_topk and ::knn_gather).

:func:`knn_topk` returns the k nearest database rows of every query,
ascending, the lower index first on ties; :func:`knn_gather` runs self-kNN
for k+1, drops slot 0 (the row minimum, normally the point itself) and
gathers the k neighbours' rows. Distances are the TPU kernel's: fp32 direct
differences for C <= 4, the norm expansion for C > 4, in the rounding order
of :func:`pairwise_sqdist` (:func:`sqdist`).

CUDA tensors launch ``csrc/knn.cu``; CPU tensors run the plain versions,
:func:`knn_topk_reference` (:func:`sqdist` + ``topk_ascending_idx``) and
:func:`knn_gather_reference` (that selection + ``grouping``). The TPU
kernel's ``M % 128`` rule (its tile) is dropped; ``k <= MAX_K`` stays (its
lane width, and the longest list the CUDA kernel keeps). The library's
callers go through :func:`knn_select` and :func:`knn_select_gather`, which
take the plain versions on any device above ``MAX_K``, as the JAX package's
``knn`` takes its XLA route there (``_pallas_knn_ok``). Indices carry no
gradient. ``knn_gather``'s backward is the scatter-add of the neighbour
cotangents (``index_add_``, outside the kernel as in JAX): on the card its
float atomics add in a run-dependent order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.knn import topk_ascending_idx
from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist

MAX_K = 128
DIRECT_MAX_C = 4    # C <= 4: direct differences; else the norm expansion


def sqdist(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """``(B, M, N)`` squared distances as the kernel takes them: for C <= 4
    ``((d0 + d1) + d2) + ...`` with ``d_c = (q_c - y_c)^2``, each step
    rounded on its own; else :func:`pairwise_sqdist`."""
    C = queries.shape[-1]
    if C > DIRECT_MAX_C:
        return pairwise_sqdist(queries, database)
    d = None
    for c in range(C):
        e = queries[:, :, None, c] - database[:, None, :, c]
        d = e * e if d is None else d + e * e
    return d


def knn_topk_reference(queries: torch.Tensor, database: torch.Tensor,
                       k: int) -> torch.Tensor:
    """The plain version: :func:`sqdist` + ``topk_ascending_idx``,
    ``(B, M, k)`` int32."""
    with torch.no_grad():
        return topk_ascending_idx(sqdist(queries, database), k)


def knn_gather_reference(x: torch.Tensor,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: self-kNN for k+1 by :func:`knn_topk_reference`,
    slot 0 dropped, then ``grouping`` (autograd gives the scatter-add)."""
    idx = knn_topk_reference(x, x, k + 1)[..., 1:].contiguous()
    return idx, grouping(x, idx)


def knn_topk_kernel(queries: torch.Tensor, database: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Launch ``pdgn_knn_topk`` (contiguous fp32 CUDA tensors)."""
    B, M, C = queries.shape
    N = database.shape[1]
    idx = torch.empty(B, M, k, device=queries.device, dtype=torch.int32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_knn_topk(
        p(queries), p(database), B, M, N, C, k, p(idx),
        _lib.stream_handle(queries.device)), "pdgn_knn_topk")
    _lib.LAUNCHES["knn_topk"] += 1
    return idx


def knn_gather_kernel(x: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``pdgn_knn_gather`` (a contiguous fp32 CUDA tensor whose
    address is a multiple of 16 bytes: the row copy moves float4s)."""
    B, M, C = x.shape
    idx = torch.empty(B, M, k, device=x.device, dtype=torch.int32)
    nbr = torch.empty(B, M, k, C, device=x.device, dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_knn_gather(
        p(x), B, M, C, k, p(idx), p(nbr), _lib.stream_handle(x.device)),
        "pdgn_knn_gather")
    _lib.LAUNCHES["knn_gather"] += 1
    return idx, nbr


class _KnnGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        idx, nbr = knn_gather_kernel(x, k)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(idx)
        return idx, nbr

    @staticmethod
    def backward(ctx, g_idx, g_nbr):
        (idx,) = ctx.saved_tensors
        B, M, k = idx.shape
        C = g_nbr.shape[-1]
        gid = idx.reshape(B, M * k).long() + (
            torch.arange(B, device=idx.device) * M)[:, None]
        dx = torch.zeros(B * M, C, device=g_nbr.device, dtype=g_nbr.dtype)
        dx.index_add_(0, gid.reshape(-1), g_nbr.reshape(B * M * k, C))
        return dx.reshape(B, M, C), None


def _check_cloud(name: str, t: torch.Tensor) -> None:
    if t.dim() != 3:
        raise ValueError(f"{name}: expected (B, rows, C), got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if min(t.shape) < 1:
        raise ValueError(f"{name}: empty {tuple(t.shape)}")


def knn_topk(queries: torch.Tensor, database: torch.Tensor,
             k: int) -> torch.Tensor:
    """Indices ``(B, M, k)`` int32 of the k nearest ``database (B, N, C)``
    rows of every ``queries (B, M, C)`` row, ascending, the lower index
    first on ties; ``1 <= k <= min(N, MAX_K)``. CUDA tensors launch the
    kernel, CPU tensors run the plain version; anything else raises."""
    _check_cloud("queries", queries)
    _check_cloud("database", database)
    if (queries.shape[0] != database.shape[0]
            or queries.shape[2] != database.shape[2]):
        raise ValueError(f"knn_topk: queries {tuple(queries.shape)} and "
                         f"database {tuple(database.shape)} differ in B or C")
    if database.device != queries.device:
        raise ValueError(f"database is on {database.device}, queries on "
                         f"{queries.device}")
    if not 1 <= k <= min(database.shape[1], MAX_K):
        raise ValueError(f"knn_topk: need 1 <= k <= min(N, {MAX_K}), got "
                         f"k={k}, N={database.shape[1]}")
    if queries.device.type == "cuda":
        _lib.check_rows(queries.shape[0], 1, "knn_topk")
        return knn_topk_kernel(queries.detach().contiguous(),
                               database.detach().contiguous(), k)
    if queries.device.type != "cpu":
        raise ValueError(f"knn_topk: unsupported device {queries.device}")
    return knn_topk_reference(queries, database, k)


def knn_gather(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN of ``x (B, M, C)`` with the nearest row dropped, fused with
    the gather: ``idx (B, M, k)`` int32 and ``nbr (B, M, k, C)`` =
    ``grouping(x, idx)`` exactly; ``1 <= k`` and ``k + 1 <= min(M, MAX_K)``.
    Differentiable in ``x``. CUDA tensors launch the kernel, CPU tensors
    run the plain version; anything else raises."""
    _check_cloud("x", x)
    if not (1 <= k and k + 1 <= min(x.shape[1], MAX_K)):
        raise ValueError(f"knn_gather: need 1 <= k and k + 1 <= min(M, "
                         f"{MAX_K}), got k={k}, M={x.shape[1]}")
    if x.device.type == "cuda":
        _lib.check_rows(x.shape[0], 1, "knn_gather")
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        return _KnnGather.apply(x, k)
    if x.device.type != "cpu":
        raise ValueError(f"knn_gather: unsupported device {x.device}")
    return knn_gather_reference(x, k)


def knn_select(queries: torch.Tensor, database: torch.Tensor,
               k: int) -> torch.Tensor:
    """:func:`knn_topk` for any k: above ``MAX_K`` the plain version, on
    every device."""
    if k > MAX_K:
        return knn_topk_reference(queries, database, k)
    return knn_topk(queries, database, k)


def knn_select_gather(x: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_gather` for any k: above ``MAX_K`` - 1 the plain version,
    on every device."""
    if k + 1 > MAX_K:
        return knn_gather_reference(x, k)
    return knn_gather(x, k)
