"""Seeding, logging, device selection, the score-indexed checkpoint
manager and small argparse helpers (port of pdgn_tpu/utils/misc.py:19-193;
reference utils/misc.py)."""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Optional

import numpy as np
import torch


class BlackHole:
    """Accepts any attribute access or call and does nothing."""

    def __setattr__(self, name, value):
        pass

    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return self


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
    as the JAX package's default compute dtype does; and bf16 products keep
    fp32 reductions (no reduced-precision split-K).
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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def get_new_log_dir(root: str = "./logs", postfix: str = "",
                    prefix: str = "") -> str:
    """A new directory under ``root`` named by the local time."""
    log_dir = os.path.join(
        root, prefix + time.strftime("%Y_%m_%d__%H_%M_%S", time.localtime())
        + postfix)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def int_tuple(argstr: str):
    return tuple(map(int, argstr.split(",")))


def str_tuple(argstr: str):
    return tuple(argstr.split(","))


def int_list(argstr: str):
    return list(map(int, argstr.split(",")))


def str_list(argstr: str):
    return list(argstr.split(","))


class CheckpointManager:
    """Score-indexed checkpoint directory (reference utils/misc.py:22-106):
    keeps the ``max_to_keep`` lowest-score checkpoints, each written with
    ``train.checkpoint.save_state`` (flax msgpack, so the JAX package's
    manager reads them too)."""

    def __init__(self, save_dir: str, max_to_keep: int = 5,
                 logger=BlackHole()):
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        self.logger = logger
        os.makedirs(save_dir, exist_ok=True)
        self.ckpts = []   # {"score", "file", "iteration"}
        for f in os.listdir(save_dir):
            if f[:4] != "ckpt":
                continue
            _, score, it = f.split("_")
            self.ckpts.append({"score": float(score), "file": f,
                               "iteration": int(it)})

    def _index(self, key: str, better) -> Optional[int]:
        """Index of the checkpoint whose ``key`` wins under ``better``
        (the last one on a tie)."""
        idx = None
        for i, ckpt in enumerate(self.ckpts):
            if idx is None or better(ckpt[key], self.ckpts[idx][key]):
                idx = i
        return idx

    def get_worst_ckpt_idx(self):
        return self._index("score", lambda a, b: a >= b)

    def get_best_ckpt_idx(self):
        return self._index("score", lambda a, b: a <= b)

    def get_latest_ckpt_idx(self):
        return self._index("iteration", lambda a, b: a > b)

    def save(self, state, score: float, step: Optional[int] = None) -> bool:
        """Save ``state`` unless ``max_to_keep`` better ones are kept; the
        worst is dropped to make room."""
        if step is None:
            step = int(time.time())
        fname = "ckpt_%.6f_%d" % (float(score), step)
        if len(self.ckpts) >= self.max_to_keep:
            idx = self.get_worst_ckpt_idx()
            if idx is not None and self.ckpts[idx]["score"] <= score:
                return False
            if idx is not None:
                old = self.ckpts.pop(idx)
                try:
                    os.remove(os.path.join(self.save_dir, old["file"]))
                except FileNotFoundError:
                    pass
        # imported here: train.checkpoint imports this package (utils)
        from pdgn_tpu_torch.train.checkpoint import save_state

        save_state(os.path.join(self.save_dir, fname), state)
        self.ckpts.append({"score": float(score), "file": fname,
                           "iteration": step})
        return True

    def _load(self, idx: Optional[int]):
        if idx is None:
            raise IOError("No checkpoints found.")
        from pdgn_tpu_torch.train.checkpoint import load_state

        return load_state(os.path.join(self.save_dir,
                                       self.ckpts[idx]["file"]))

    def load_best(self):
        return self._load(self.get_best_ckpt_idx())

    def load_latest(self):
        return self._load(self.get_latest_ckpt_idx())


def log_hyperparams(writer, args) -> None:
    """Record an argparse namespace with a summary writer (reference
    utils/misc.py:156-162): ``add_hparams`` with non-strings ``repr``'d,
    else one ``add_text`` summary."""
    vars_args = {k: v if isinstance(v, str) else repr(v)
                 for k, v in vars(args).items()}
    if hasattr(writer, "add_hparams"):
        writer.add_hparams(vars_args, {})
        return
    text = "\n".join(f"{k}: {v}" for k, v in sorted(vars_args.items()))
    writer.add_text("hyperparams", text)
