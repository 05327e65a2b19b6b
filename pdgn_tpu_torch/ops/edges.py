"""Feature-space kNN graph of the generator's edge convolutions (port of
pdgn_tpu/ops/edges.py::_neighbor_idx, exact regime only).

The port builds the fp32-exact graph, which is what the JAX package builds
under ``--exact_knn 1``: norm-expansion distances, ascending order, lowest
index first, row minimum dropped. The TPU's bf16 packed-key selection is not
ported.
"""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.knn import knn_exclude_first
from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist


def neighbor_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, N, C) -> (B, N, k)`` int32 indices 1..k of the ascending order."""
    return knn_exclude_first(self_pairwise_sqdist(x), k)
