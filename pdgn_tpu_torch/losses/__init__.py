"""Losses of the port (LSGAN, Chamfer, approximate EMD, shape-preserving)."""

from pdgn_tpu_torch.losses.chamfer import (chamfer_cd, chamfer_loss,
                                           dist_chamfer)
from pdgn_tpu_torch.losses.emd import emd_approx, match_cost
from pdgn_tpu_torch.losses.gan import d_loss, g_adv_loss, mse_loss
from pdgn_tpu_torch.losses.shape_preserving import (compute_mean_covariance,
                                                    get_local_pair,
                                                    shape_preserving_loss,
                                                    shape_preserving_terms)

__all__ = [
    "chamfer_cd",
    "chamfer_loss",
    "compute_mean_covariance",
    "d_loss",
    "dist_chamfer",
    "emd_approx",
    "g_adv_loss",
    "get_local_pair",
    "match_cost",
    "mse_loss",
    "shape_preserving_loss",
    "shape_preserving_terms",
]
