"""Feature-space kNN graphs and edge features (port of
pdgn_tpu/ops/edges.py, exact regime only).

The port builds the fp32-exact graph, which is what the JAX package builds
under ``--exact_knn 1``: ascending order, lowest index first, row minimum
dropped (the reference's ``sort(dist)[..., 1:k+1]``,
models/PDGNet_v2.py:457-458). The selection is the ``knn_topk`` kernel on
the card (``knn_gather`` for :func:`neighbor_features`) and the kernels'
plain versions on the CPU, both through ``kernels.knn``'s routes (a graph
of more than ``MAX_K`` - 1 neighbours takes the plain version on any
device, as the JAX package's XLA route). The TPU's bf16 regime
(``exact_knn_scope``, ``_graph_precision``) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels.knn import knn_select, knn_select_gather


def neighbor_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, N, C) -> (B, N, k)`` int32 indices 1..k of the ascending order."""
    return knn_select(x, x, k + 1)[..., 1:]


def neighbor_features(x: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices ``(B, N, k)`` of :func:`neighbor_idx` and the raw neighbour
    rows ``(B, N, k, C)``, the un-materialised half of
    :func:`edge_features`; one fused kernel on the card."""
    return knn_select_gather(x, k)


def edge_features(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[central, neighbour - central]`` of ``x (B, N, C)``:
    ``(B, N, k, 2C)``."""
    nbr = grouping(x, neighbor_idx(x, k))
    central = x[:, :, None, :].expand_as(nbr)
    return torch.cat([central, nbr - central], dim=-1)


def edge_features_xyz(x: torch.Tensor, pc: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge features of ``x (B, N, C)`` and of the coordinates
    ``pc (B, N, 3)`` over the same feature-space graph: ``(B, N, k, 2C)``
    and ``(B, N, k, 6)``."""
    idx = neighbor_idx(x, k)
    nbr_fea = grouping(x, idx)
    nbr_xyz = grouping(pc, idx)
    central_fea = x[:, :, None, :].expand_as(nbr_fea)
    central_xyz = pc[:, :, None, :].expand_as(nbr_xyz)
    return (torch.cat([central_fea, nbr_fea - central_fea], dim=-1),
            torch.cat([central_xyz, nbr_xyz - central_xyz], dim=-1))
