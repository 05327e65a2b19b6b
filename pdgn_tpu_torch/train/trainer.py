"""The GAN trainer's train phase (port of pdgn_tpu/train/trainer.py:51-329,
reference models/PDGNet_v2.py:26-256).

Owns the dataset, the generator and the four discriminators on one device,
the five Adam optimizers, the train loop with the reference's per-batch log
line, and the two-bundle ``.pth`` checkpoints (at every ``snapshot``-th
epoch and at the end; ``--pretrain_model_G/_D`` resume). Randomness follows
the JAX trainer: the initial weights and the training noise come from seeds
drawn from numpy's global stream (``np.random.randint``), which the CLI seeds
per run. Only the synthetic dataset is ported.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from pdgn_tpu_torch.data.shapenet import SyntheticShapes, batch_iterator
from pdgn_tpu_torch.models.discriminator import discriminators
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.train import checkpoint as ckpt_lib
from pdgn_tpu_torch.train.train_step import (GANState, TrainConfig,
                                             init_state, train_step)
from pdgn_tpu_torch.utils.misc import resolve_device


@dataclasses.dataclass
class ExperimentConfig:
    """CLI-level configuration (reference main.py:12-42 flags)."""

    network: str = "PDGNet_v2"           # PDGNet | PDGNet_v2
    batch_size: int = 50
    num_point: int = 2048
    num_k: int = 20
    learning_rate: float = 1e-4
    max_epoch: int = 300
    noise_dim: int = 128
    log_info: str = "log_info.txt"
    model_dir: str = "default"
    checkpoint_dir: str = "checkpoint"
    snapshot: int = 20
    choice: Optional[str] = None
    pretrain_model_G: Optional[str] = None
    pretrain_model_D: Optional[str] = None
    softmax: bool = True
    dataset: str = "synthetic"
    synthetic_size: int = 64
    max_steps_per_epoch: Optional[int] = None
    base_points: int = 128
    device: str = "cuda"

    @property
    def category(self) -> str:
        return self.choice if self.choice is not None else "full"


def train_config(cfg: ExperimentConfig) -> TrainConfig:
    """v1 (PDGNet) or v2 loss weights."""
    if cfg.network == "PDGNet":
        return TrainConfig.v1(learning_rate=cfg.learning_rate,
                              noise_dim=cfg.noise_dim)
    return TrainConfig(learning_rate=cfg.learning_rate,
                       noise_dim=cfg.noise_dim)


class PDGNTrainer:
    """Models, optimizers, data and the train loop on ``cfg.device``."""

    def __init__(self, cfg: ExperimentConfig):
        if cfg.dataset != "synthetic":
            raise NotImplementedError(
                f"dataset {cfg.dataset!r} is not ported yet to pdgn_tpu_torch "
                "(use --dataset synthetic, or pdgn_tpu for the hdf5 sets)")
        self.cfg = cfg
        self.tcfg = train_config(cfg)
        self.device = resolve_device(cfg.device)
        self.sizes = tuple(cfg.base_points * 2 ** i for i in range(1, 5))
        self.state: Optional[GANState] = None
        self.step_seconds: list = []     # wall time of each step, metrics read
        self.last_metrics: dict = {}
        self._log_fout = None

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.cfg.checkpoint_dir, self.cfg.model_dir,
                            self.cfg.network)

    def log_string(self, s: str) -> None:
        print(s)
        if self._log_fout is not None:
            self._log_fout.write(s + "\n")
            self._log_fout.flush()

    def build_model(self, seed: Optional[int] = None) -> None:
        """Generator + discriminators drawn (torch default init) from a CPU
        ``torch.Generator`` seeded with ``seed`` (default: drawn from numpy),
        moved to the device, with fresh optimizers."""
        cfg = self.cfg
        seed = seed if seed is not None else int(np.random.randint(0, 2 ** 31))
        gen = torch.Generator().manual_seed(seed)
        softmax = cfg.softmax if cfg.network == "PDGNet" else True
        g = PointGenerator(cfg.num_point, cfg.num_k, softmax=softmax,
                           base_points=cfg.base_points,
                           noise_dim=cfg.noise_dim)
        g.reset_parameters(gen)
        ds = discriminators()
        for d in ds:
            d.reset_parameters(gen)
        self.state = init_state(g.to(self.device),
                                [d.to(self.device) for d in ds], self.tcfg)

    def save(self, epoch: int) -> None:
        path_g, path_d = ckpt_lib.save(self.ckpt_dir, self.state, epoch,
                                       self.cfg.category)
        print(f"Save Path for G: {path_g}")
        print(f"Save Path for D: {path_d}")

    def load(self) -> Tuple[bool, int]:
        """Resume from --pretrain_model_G/--pretrain_model_D (both or none,
        as the reference, models/PDGNet_v2.py:333-382)."""
        cfg = self.cfg
        if cfg.pretrain_model_G is None and cfg.pretrain_model_D is None:
            print("################ new training ################")
            return False, 1
        if cfg.pretrain_model_G is None or cfg.pretrain_model_D is None:
            raise FileNotFoundError(
                "both pretrain_model_G and pretrain_model_D are required")
        epoch = ckpt_lib.load(os.path.join(self.ckpt_dir, cfg.pretrain_model_G),
                              os.path.join(self.ckpt_dir, cfg.pretrain_model_D),
                              self.state)
        print(f" [*] Success to load model --> {cfg.pretrain_model_G} & "
              f"{cfg.pretrain_model_D}")
        return True, epoch

    def train(self, seed: Optional[int] = None) -> None:
        """The train loop; ``seed`` seeds the noise generator (default:
        drawn from numpy, as the JAX trainer draws its key)."""
        cfg = self.cfg
        os.makedirs(os.path.join(cfg.checkpoint_dir, cfg.model_dir),
                    exist_ok=True)
        self._log_fout = open(os.path.join(cfg.checkpoint_dir, cfg.model_dir,
                                           cfg.log_info), "w")
        self._log_fout.write(str(cfg) + "\n")
        if self.state is None:
            self.build_model()
        could_load, save_epoch = self.load()
        start_epoch = save_epoch if could_load else 1
        if could_load:
            print(" [*] Load SUCCESS")
        else:
            print(f" [!] start epoch: {start_epoch}")

        dataset = SyntheticShapes(size=cfg.synthetic_size,
                                  num_points=self.sizes[-1])
        num_batches = len(dataset) // cfg.batch_size
        seed = seed if seed is not None else int(np.random.randint(0, 2 ** 31))
        rng = torch.Generator(device=self.device).manual_seed(seed)
        B, dev, sigma = cfg.batch_size, self.device, self.tcfg.noise_sigma

        start_time = time.time()
        for epoch in range(start_epoch, cfg.max_epoch + 1):
            for idx, batch in enumerate(batch_iterator(dataset, B)):
                if cfg.max_steps_per_epoch and idx >= cfg.max_steps_per_epoch:
                    break
                t0 = time.perf_counter()
                reals = [torch.from_numpy(p).to(dev) for p in batch[:4]]
                noise = [sigma * torch.randn(B, cfg.noise_dim, generator=rng,
                                             device=dev) for _ in range(2)]
                metrics = train_step(self.state, reals, *noise, self.tcfg)
                m = {k: float(v) for k, v in metrics.items()}
                self.step_seconds.append(time.perf_counter() - t0)
                self.last_metrics = m
                el = time.time() - start_time
                self.log_string(
                    "Epoch: [%2d] [%4d/%4d] time: %2dm %2ds d_loss1: %.8f "
                    "d_loss2: %.8f d_loss3: %.8f d_loss4: %.8f, g_loss: %.8f,"
                    " similar_loss: %.8f"
                    % (epoch, idx + 1, num_batches, el / 60, el % 60,
                       m["d_loss1"], m["d_loss2"], m["d_loss3"], m["d_loss4"],
                       m["g_loss"], m["similar_loss"]))
            if epoch % cfg.snapshot == 0:
                self.save(epoch)
        self.save(cfg.max_epoch)
        self._log_fout.close()
        self._log_fout = None
