"""Utilities of the port (logging, seeding, checkpoint manager, msgpack)."""

from pdgn_tpu_torch.utils.misc import (BlackHole, CheckpointManager,
                                       get_logger, get_new_log_dir, int_list,
                                       int_tuple, log_hyperparams, seed_all,
                                       str_list, str_tuple)

__all__ = [
    "BlackHole",
    "CheckpointManager",
    "get_logger",
    "get_new_log_dir",
    "int_list",
    "int_tuple",
    "log_hyperparams",
    "seed_all",
    "str_list",
    "str_tuple",
]
