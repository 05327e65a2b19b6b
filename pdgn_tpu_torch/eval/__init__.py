"""Evaluation metric suite of the port (MMD/COV/1-NNA for CD and EMD, JSD)."""

from pdgn_tpu_torch.eval.metrics import (
    EMD_CD,
    compute_all_metrics,
    entropy_of_occupancy_grid,
    jensen_shannon_divergence,
    jsd_between_point_cloud_sets,
    knn_classifier,
    lgan_mmd_cov,
    pairwise_cd_emd,
    unit_cube_grid_point_cloud,
)

__all__ = [
    "EMD_CD",
    "compute_all_metrics",
    "entropy_of_occupancy_grid",
    "jensen_shannon_divergence",
    "jsd_between_point_cloud_sets",
    "knn_classifier",
    "lgan_mmd_cov",
    "pairwise_cd_emd",
    "unit_cube_grid_point_cloud",
]
