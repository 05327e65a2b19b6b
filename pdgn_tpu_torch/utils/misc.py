"""Seeding, logging and device selection (port of pdgn_tpu/utils/misc.py:
``seed_all``, ``get_logger``)."""

from __future__ import annotations

import logging
import os
import random
from typing import Optional

import numpy as np
import torch


def seed_all(seed: int) -> None:
    """Seed python, numpy and torch's default generators (reference
    utils/misc.py:109-112)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_logger(name: str, log_dir: Optional[str] = None) -> logging.Logger:
    """Stream+file logger with the reference's format string."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    formatter = logging.Formatter(
        "[%(asctime)s::%(name)s::%(levelname)s] %(message)s")
    stream_handler = logging.StreamHandler()
    stream_handler.setLevel(logging.DEBUG)
    stream_handler.setFormatter(formatter)
    logger.addHandler(stream_handler)
    if log_dir is not None:
        file_handler = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        file_handler.setLevel(logging.INFO)
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
    return logger


def resolve_device(device: str = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is visible: nothing drops silently to
    the CPU, which runs only when asked for.

    Also turns TF32 off for matmuls and cuDNN: the port serves in full fp32,
    as the JAX package's default compute dtype does.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
