"""The port's point-op library (the counterpart of ``pdgn_tpu.ops`` and of
the reference's ``lib/pointops``), and its kernels (``kernels``).

Plain PyTorch, channel-last like the JAX package; the kNN queries run
through the ``knn_topk`` and ``knn_gather`` CUDA kernels on the card.
"""

from pdgn_tpu_torch.ops.ballquery import ballquery
from pdgn_tpu_torch.ops.edges import (edge_features, edge_features_xyz,
                                      neighbor_features)
from pdgn_tpu_torch.ops.featuredistribute import (feature_distribute,
                                                  feature_gather)
from pdgn_tpu_torch.ops.grouping import (group_all, group_xyz, grouping,
                                         grouping_int, le_query_and_group,
                                         le_query_and_group_only_feature,
                                         le_query_and_group_same_size,
                                         query_and_group,
                                         query_and_group_dilate)
from pdgn_tpu_torch.ops.interpolation import (interpolate,
                                              three_interpolate_weights,
                                              three_nn)
from pdgn_tpu_torch.ops.knn import knn, knn_exclude_first, knn_naive
from pdgn_tpu_torch.ops.labelstat import (labelstat_and_ballquery,
                                          labelstat_ballrange, labelstat_idx)
from pdgn_tpu_torch.ops.pairwise import pairwise_sqdist, self_pairwise_sqdist
from pdgn_tpu_torch.ops.sampling import furthest_point_sample, gather_points

__all__ = [
    "ballquery",
    "edge_features",
    "edge_features_xyz",
    "feature_distribute",
    "feature_gather",
    "furthest_point_sample",
    "gather_points",
    "group_all",
    "group_xyz",
    "grouping",
    "grouping_int",
    "interpolate",
    "knn",
    "knn_exclude_first",
    "knn_naive",
    "labelstat_and_ballquery",
    "labelstat_ballrange",
    "labelstat_idx",
    "le_query_and_group",
    "le_query_and_group_only_feature",
    "le_query_and_group_same_size",
    "neighbor_features",
    "pairwise_sqdist",
    "query_and_group",
    "query_and_group_dilate",
    "self_pairwise_sqdist",
    "three_interpolate_weights",
    "three_nn",
]
