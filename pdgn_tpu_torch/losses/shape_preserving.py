"""Shape-preserving multi-resolution loss (port of
pdgn_tpu/losses/shape_preserving.py; reference ``get_local_pair`` /
``compute_mean_covariance``, models/PDGNet_v2.py:127-155).

For each pair of generated resolutions, both clouds' k-neighbourhoods around
the coarser cloud's points are reduced to their mean and covariance
(:func:`~pdgn_tpu_torch.ops.kernels.local_stats.local_mean_cov`, one CUDA
kernel each way on the card), and the Chamfer distances between the two
statistic sets, over the coarse point count, are the loss terms. They
sum over the clouds (no mean), so on a data-parallel rank the terms of its
rows are its share of the global batch's, as they are. The JAX package's
``mask`` argument has no counterpart: a rank holds only real rows.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pdgn_tpu_torch.losses.chamfer import chamfer_loss
from pdgn_tpu_torch.ops.kernels.local_stats import (  # noqa: F401
    compute_mean_covariance, local_mean_cov)


def get_local_pair(pt1: torch.Tensor, pt2: torch.Tensor, nsample: int = 20
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(like_mu, like_cov)`` of the coarser ``pt1 (B, M, 3)`` and finer
    ``pt2 (B, N, 3)``, both neighbourhood sets centred on ``pt1``."""
    M = pt1.shape[1]
    mu1, cov1 = local_mean_cov(pt1, pt1, nsample)
    mu2, cov2 = local_mean_cov(pt2, pt1, nsample)
    return (chamfer_loss(mu1, mu2) / float(M),
            chamfer_loss(cov1, cov2) / float(M))


def shape_preserving_terms(clouds: Sequence[torch.Tensor], nsample: int = 20
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mu_total, cov_total)`` over the resolution pairs (i < j). The
    self statistics of each coarse cloud are computed once and shared by
    its pairs: 3 + 6 = 9 :func:`local_mean_cov` calls for four clouds."""
    self_stats = {i: local_mean_cov(clouds[i], clouds[i], nsample)
                  for i in range(len(clouds) - 1)}
    mu_total = cov_total = 0.0
    for i in range(len(clouds)):
        for j in range(i + 1, len(clouds)):
            M = clouds[i].shape[1]
            mu1, cov1 = self_stats[i]
            mu2, cov2 = local_mean_cov(clouds[j], clouds[i], nsample)
            mu_total = mu_total + chamfer_loss(mu1, mu2) / float(M)
            cov_total = cov_total + chamfer_loss(cov1, cov2) / float(M)
    return mu_total, cov_total


def shape_preserving_loss(clouds: Sequence[torch.Tensor], nsample: int = 20,
                          mu_weight: float = 1.0, cov_weight: float = 1.0
                          ) -> torch.Tensor:
    """``mu_weight * mu_total + cov_weight * cov_total`` over the resolution
    pairs (:func:`shape_preserving_terms`): the reference weights them 1/1
    in v2 (models/PDGNet_v2.py:251-252) and 1/5 in v1
    (models/PDGNet.py:262-263)."""
    mu_total, cov_total = shape_preserving_terms(clouds, nsample)
    return mu_weight * mu_total + cov_weight * cov_total
