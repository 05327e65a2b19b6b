"""Neighbourhood gathering (port of pdgn_tpu/ops/grouping.py): the gathers
of the reference's grouping kernels and its ``QueryAndGroup`` family
(lib/pointops/functions/pointops.py:476-777), channel-last.

Every kNN query goes through :func:`pdgn_tpu_torch.ops.knn.knn`, so through
the ``knn_topk`` kernel on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pdgn_tpu_torch.ops.ballquery import ballquery
from pdgn_tpu_torch.ops.knn import knn


def grouping(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``features (B, N, C)``, ``idx (B, M, K)`` -> ``(B, M, K, C)``."""
    B, N, C = features.shape
    _, M, K = idx.shape
    gid = idx.reshape(B, M * K).long() + (
        torch.arange(B, device=idx.device) * N)[:, None]
    out = features.reshape(B * N, C).index_select(0, gid.reshape(-1))
    return out.reshape(B, M, K, C)


def grouping_int(labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``labels (B, N)`` integers, ``idx (B, M, K)`` -> ``(B, M, K)``."""
    B = labels.shape[0]
    _, M, K = idx.shape
    out = torch.gather(labels, 1, idx.reshape(B, M * K).long())
    return out.reshape(B, M, K)


def _query(xyz, new_xyz, nsample: int, radius: Optional[float]):
    if radius is not None:
        return ballquery(radius, nsample, xyz, new_xyz)
    return knn(xyz, new_xyz, nsample)


def _centred_and_features(xyz, new_xyz, features, idx, use_xyz: bool):
    grouped_xyz = grouping(xyz, idx) - new_xyz[:, :, None, :]
    if features is not None:
        grouped = grouping(features, idx)
        if use_xyz:
            return torch.cat([grouped_xyz, grouped], dim=-1)
        return grouped
    if not use_xyz:
        raise ValueError("Cannot have no features and not use xyz as a "
                         "feature")
    return grouped_xyz


def group_xyz(xyz: torch.Tensor, new_xyz: Optional[torch.Tensor] = None, *,
              nsample: int = 32, radius: Optional[float] = None
              ) -> torch.Tensor:
    """Raw neighbour coordinates ``(B, M, nsample, 3)`` around each center
    (no centering): kNN, or ball query when ``radius`` is given (reference
    ``Gen_QueryAndGroupXYZ``)."""
    if new_xyz is None:
        new_xyz = xyz
    return grouping(xyz, _query(xyz, new_xyz, nsample, radius))


def query_and_group(xyz: torch.Tensor, new_xyz: Optional[torch.Tensor] = None,
                    features: Optional[torch.Tensor] = None,
                    idx: Optional[torch.Tensor] = None, *, nsample: int = 32,
                    radius: Optional[float] = None,
                    use_xyz: bool = True) -> torch.Tensor:
    """Centred neighbour coordinates, with the grouped features after them
    (reference ``QueryAndGroup``): ``(B, M, nsample, 3 + C)``, ``(..., C)``
    without ``use_xyz``, ``(..., 3)`` without features."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = _query(xyz, new_xyz, nsample, radius)
    return _centred_and_features(xyz, new_xyz, features, idx, use_xyz)


def le_query_and_group(xyz: torch.Tensor,
                       new_xyz: Optional[torch.Tensor] = None,
                       features: Optional[torch.Tensor] = None,
                       idx: Optional[torch.Tensor] = None, *,
                       nsample: int = 32, radius: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(grouped_xyz, grouped_features)`` apart (reference
    ``Le_QueryAndGroup``); features are required."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = _query(xyz, new_xyz, nsample, radius)
    grouped_xyz = grouping(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        raise ValueError("Le_QueryAndGroup requires features")
    return grouped_xyz, grouping(features, idx)


def le_query_and_group_same_size(xyz: torch.Tensor,
                                 new_xyz: Optional[torch.Tensor] = None,
                                 features: Optional[torch.Tensor] = None,
                                 idx: Optional[torch.Tensor] = None, *,
                                 nsample: int = 32,
                                 radius: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`le_query_and_group` for equal point and center sets
    (reference ``Le_QueryAndGroup_SameSize``)."""
    if new_xyz is not None and xyz.shape != new_xyz.shape:
        raise ValueError(f"xyz and new_xyz must match: {tuple(xyz.shape)} "
                         f"vs {tuple(new_xyz.shape)}")
    return le_query_and_group(xyz, new_xyz, features, idx, nsample=nsample,
                              radius=radius)


def le_query_and_group_only_feature(xyz: torch.Tensor,
                                    new_xyz: Optional[torch.Tensor] = None,
                                    features: Optional[torch.Tensor] = None,
                                    idx: Optional[torch.Tensor] = None, *,
                                    nsample: int = 32,
                                    radius: Optional[float] = None
                                    ) -> torch.Tensor:
    """Grouped features only (reference ``Le_QueryAndGroup_OnlyFeature``)."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = _query(xyz, new_xyz, nsample, radius)
    if features is None:
        raise ValueError("Le_QueryAndGroup_OnlyFeature requires features")
    return grouping(features, idx)


def query_and_group_dilate(xyz: torch.Tensor,
                           new_xyz: Optional[torch.Tensor] = None,
                           features: Optional[torch.Tensor] = None,
                           idx: Optional[torch.Tensor] = None, *,
                           generator: Optional[torch.Generator] = None,
                           nsample: int = 32, radius: Optional[float] = None,
                           use_xyz: bool = True) -> torch.Tensor:
    """Query ``2 * nsample`` neighbours and keep a random ``nsample`` of the
    slots, one draw for the whole batch (reference ``QueryAndGroup_Dilate``).
    The draw is ``torch.randperm`` from ``generator`` (the JAX package's
    PRNG key), required unless ``idx`` has ``nsample`` columns already."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = _query(xyz, new_xyz, 2 * nsample, radius)
    if idx.shape[-1] != nsample:
        if generator is None:
            raise ValueError("query_and_group_dilate needs a generator")
        slots = torch.randperm(idx.shape[-1], generator=generator,
                               device=generator.device)[:nsample]
        idx = idx[:, :, slots.to(idx.device)]
    return _centred_and_features(xyz, new_xyz, features, idx, use_xyz)


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor] = None, *,
              use_xyz: bool = True) -> torch.Tensor:
    """The whole cloud as one neighbourhood (reference ``GroupAll``):
    ``(B, 1, N, 3 + C)``, ``(B, 1, N, C)`` or ``(B, 1, N, 3)``."""
    grouped_xyz = xyz[:, None, :, :]
    if features is not None:
        grouped = features[:, None, :, :]
        if use_xyz:
            return torch.cat([grouped_xyz, grouped], dim=-1)
        return grouped
    return grouped_xyz
