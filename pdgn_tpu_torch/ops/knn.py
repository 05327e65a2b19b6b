"""Exact k-nearest-neighbour queries (port of pdgn_tpu/ops/knn.py).

Ascending distance, lowest index first on ties (the reference's insertion
sort, knnquery_cuda_kernel.cu, keeps the first index it saw).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist


def knn(xyz: torch.Tensor, new_xyz: Optional[torch.Tensor], k: int, *,
        return_dist: bool = False
        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """k nearest points of ``xyz (B, N, C)`` around each center of
    ``new_xyz (B, M, C)`` (``None``: ``xyz`` itself, each point then among
    its own neighbours), the reference ``pointops.knnquery``.

    Returns ``idx (B, M, k)`` int32 ascending (and ``dist2 (B, M, k)`` with
    ``return_dist``). The indices come from ``kernels.knn.knn_select``: the
    ``knn_topk`` CUDA kernel on the card, its plain version on the CPU and
    for ``k > MAX_K`` (128). For C <= 4 that selection ranks by fp32 direct
    differences on every device, as the TPU kernel and the reference's
    CUDA kernel do, where the JAX package's CPU route ranks by the norm
    expansion. ``return_dist`` takes the JAX package's plain route:
    :func:`pairwise_sqdist` + :func:`topk_ascending_idx`, indices and
    distances from the norm expansion, so at near-ties its indices can
    differ from those of the call without it.
    """
    # imported here: kernels.knn imports this module
    from pdgn_tpu_torch.ops.kernels.knn import knn_select

    if new_xyz is None:
        new_xyz = xyz
    if not return_dist:
        return knn_select(new_xyz, xyz, k)
    dist = pairwise_sqdist(new_xyz, xyz)
    idx = topk_ascending_idx(dist, k)
    return idx, torch.gather(dist, -1, idx.long())


def topk_ascending_idx(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries per row, ascending, ``int32``.

    k passes of argmin + mask: ``torch.argmin`` returns the first minimal
    index, which is the lowest-index-first tie-break.
    """
    d = dist.clone()
    idxs = []
    for _ in range(k):
        i = torch.argmin(d, dim=-1, keepdim=True)
        idxs.append(i)
        d.scatter_(-1, i, float("inf"))
    return torch.cat(idxs, dim=-1).to(torch.int32)


def knn_exclude_first(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Neighbour indices 1..k of the ascending order: the row minimum
    (normally the point itself) is dropped, as the reference generator's
    ``sort(dist)[..., 1:k+1]`` (models/PDGNet_v2.py:457-458)."""
    return topk_ascending_idx(dist, k + 1)[..., 1:]


def knn_naive(xyz: torch.Tensor, new_xyz: Optional[torch.Tensor],
              k: int) -> torch.Tensor:
    """Stable-argsort oracle for :func:`knn` (the reference's
    ``KNNQueryNaive``, pointops.py:368-405)."""
    if new_xyz is None:
        new_xyz = xyz
    order = torch.argsort(pairwise_sqdist(new_xyz, xyz), dim=-1, stable=True)
    return order[..., :k].to(torch.int32)
