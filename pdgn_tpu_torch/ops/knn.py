"""Exact k-nearest-neighbour selection (port of pdgn_tpu/ops/knn.py).

Ascending distance, lowest index first on ties (the reference's insertion
sort, knnquery_cuda_kernel.cu, keeps the first index it saw).
"""

from __future__ import annotations

import torch


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
