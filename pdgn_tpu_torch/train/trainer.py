"""The GAN trainer: train and test phases (port of
pdgn_tpu/train/trainer.py, reference models/PDGNet_v2.py:26-430).

Owns the dataset (shapenet15k, ModelNet10/40 or synthetic), the generator
and the four discriminators on one device, the five Adam optimizers, the
train loop fed by ``data.train_loader`` (pinned host batches copied on a
side stream) with the reference's per-batch log line, the two-bundle
checkpoints (``.pth`` written at every ``snapshot``-th epoch and at the
end; ``--pretrain_model_G/_D`` resume from ``.pth`` or the JAX package's
``.msgpack``), an optional ``torch.profiler`` trace of global steps 2..4,
and the test phase: sampling with sigma=1 noise, renormalisation, the
metric suite against the dataset's test split and the npy dumps.
``compute_dtype="bfloat16"`` builds the generator in the JAX package's bf16
policy (as pdgn_tpu/train/trainer.py:148-151) for the train and test
phases: bf16 activations and product operands through the kernels' bf16
instances, forward and backward, with fp32 parameters, BN statistics, Adam
moments and clouds. The discriminators stay fp32 unless ``d_compute_dtype``
is "bfloat16" (their conv stacks then compute in bf16; the JAX trainer's
warning: bf16 discriminators collapsed LSGAN training on the TPU).
Randomness follows the JAX trainer: the initial weights and the training
noise come from seeds drawn from numpy's global stream
(``np.random.randint``), which the CLI seeds per run, as do the loader's
shuffles and sub-resolution draws; the test phase seeds everything from
``seed``.

With a :class:`~pdgn_tpu_torch.parallel.mesh.Mesh` (one process per
device, the JAX trainer's data-parallel mesh) every rank builds the same
models, which rank 0's are then broadcast over, and trains them on its rows
of each global batch with global batch statistics and summed gradients
(``train_step``); every rank shuffles the epoch alike (numpy's stream,
seeded equally on every rank by the caller) and copies only its rows to its
card, and draws the global noise. The test phase hands whole batches of
generation to the ranks in turn and distributes the pairwise matrices' row
tiles. Rank 0 alone writes the bundles, the log file, the npy dumps and the
log lines, and computes JSD.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from pdgn_tpu_torch.data import (ModelNetDataset, ShapeNetCore,
                                 SyntheticShapes, train_loader)
from pdgn_tpu_torch.eval.metrics import (compute_all_metrics,
                                         jsd_between_point_cloud_sets)
from pdgn_tpu_torch.models.discriminator import discriminators
from pdgn_tpu_torch.models.generator import PointGenerator
from pdgn_tpu_torch.parallel.mesh import Mesh, replicate
from pdgn_tpu_torch.train import checkpoint as ckpt_lib
from pdgn_tpu_torch.train.generate import generate
from pdgn_tpu_torch.train.train_step import (GANState, TrainConfig,
                                             init_state, train_step)
from pdgn_tpu_torch.utils.misc import (BlackHole, get_logger,
                                       resolve_device, seed_all)


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
    dataset: str = "synthetic"          # shapenet15k | modelnet10/40 | synthetic
    data_root: str = "shapenet.hdf5"    # the hdf5 file or ModelNet root
    synthetic_size: int = 64
    max_steps_per_epoch: Optional[int] = None
    base_points: int = 128
    normalize: Optional[str] = "shape_bbox"  # test phase: renormalisation,
    seed: int = 9999                         # noise seed and output root
    save_dir: str = "./results"
    device: str = "cuda"
    profile_dir: Optional[str] = None   # torch.profiler trace of steps 2..4
    compute_dtype: Optional[str] = None    # None/"float32" or "bfloat16"
    d_compute_dtype: Optional[str] = None  # None/"float32" or "bfloat16"

    @property
    def category(self) -> str:
        return self.choice if self.choice is not None else "full"


def generator_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    """A model's ``dtype`` for a ``--compute_dtype`` (or
    ``--d_compute_dtype``) value: None (fp32) for None or "float32",
    ``torch.bfloat16`` for "bfloat16"."""
    if compute_dtype in (None, "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def train_config(cfg: ExperimentConfig) -> TrainConfig:
    """v1 (PDGNet) or v2 loss weights."""
    if cfg.network == "PDGNet":
        return TrainConfig.v1(learning_rate=cfg.learning_rate,
                              noise_dim=cfg.noise_dim)
    return TrainConfig(learning_rate=cfg.learning_rate,
                       noise_dim=cfg.noise_dim)


def normalize_point_clouds(pcs: np.ndarray, mode: Optional[str],
                           logger=None) -> np.ndarray:
    """Per-cloud renormalisation of generated clouds (reference
    models/PDGNet_v2.py:413-430): ``shape_unit`` (mean, ddof=1 std as
    torch's ``.std()``) or ``shape_bbox`` (bounding-box centre and half its
    largest side)."""
    if mode is None:
        if logger:
            logger.info("Will not normalize point clouds.")
        return pcs
    if logger:
        logger.info("Normalization mode: %s" % mode)
    out = pcs.copy()
    for i in range(pcs.shape[0]):
        pc = pcs[i]
        if mode == "shape_unit":
            shift = pc.mean(axis=0, keepdims=True)
            scale = pc.flatten().std(ddof=1).reshape(1, 1)
        elif mode == "shape_bbox":
            pc_max = pc.max(axis=0, keepdims=True)
            pc_min = pc.min(axis=0, keepdims=True)
            shift = (pc_min + pc_max) / 2.0
            scale = (pc_max - pc_min).max().reshape(1, 1) / 2.0
        else:
            raise ValueError(f"unknown normalize mode {mode}")
        out[i] = (pc - shift) / scale
    return out


class PDGNTrainer:
    """Models, optimizers, data and the train loop on ``cfg.device``, or
    on ``mesh.device`` as one rank of a data-parallel run."""

    def __init__(self, cfg: ExperimentConfig, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.tcfg = train_config(cfg)
        self.mesh = mesh
        self.rank0 = mesh is None or mesh.rank == 0
        if mesh is not None and mesh.device.type != torch.device(
                cfg.device).type:
            raise ValueError(f"the mesh's device {mesh.device} is not a "
                             f"{cfg.device} device")
        self.device = resolve_device(cfg.device if mesh is None
                                     else mesh.device)
        self.sizes = tuple(cfg.base_points * 2 ** i for i in range(1, 5))
        self.state: Optional[GANState] = None
        self.step_seconds: list = []     # wall time of each step, metrics read
        self.wait_seconds: list = []     # each step's wait for its batch
        self.last_metrics: dict = {}
        self._log_fout = None

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.cfg.checkpoint_dir, self.cfg.model_dir,
                            self.cfg.network)

    def log_string(self, s: str) -> None:
        if not self.rank0:
            return
        print(s)
        if self._log_fout is not None:
            self._log_fout.write(s + "\n")
            self._log_fout.flush()

    def _make_dataset(self, split: str, scale_mode: Optional[str]):
        """The split of the configured dataset (pdgn_tpu/train/trainer.py:
        188-204): the train phase asks for ``shape_unit``, the test phase
        for ``cfg.normalize``."""
        cfg = self.cfg
        if cfg.dataset == "shapenet15k":
            return ShapeNetCore(path=cfg.data_root, cates_list=cfg.choice,
                                split=split, scale_mode=scale_mode)
        if cfg.dataset in ("modelnet10", "modelnet40"):
            return ModelNetDataset(
                root=cfg.data_root, batch_size=cfg.batch_size,
                split="train" if split == "train" else "test",
                normalize=True, normal_channel=False,
                modelnet10=(cfg.dataset == "modelnet10"),
                class_choice=cfg.choice)
        if cfg.dataset == "synthetic":
            return SyntheticShapes(size=cfg.synthetic_size,
                                   num_points=self.sizes[-1])
        raise ValueError(f"unknown dataset {cfg.dataset}")

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
                           noise_dim=cfg.noise_dim,
                           dtype=generator_dtype(cfg.compute_dtype))
        g.reset_parameters(gen)
        # fp32 discriminators unless asked for: the JAX trainer keeps them
        # fp32 under --compute_dtype bfloat16 (bf16 ones collapsed LSGAN
        # training on the TPU)
        ds = discriminators(generator_dtype(cfg.d_compute_dtype))
        for d in ds:
            d.reset_parameters(gen)
        self.state = init_state(g.to(self.device),
                                [d.to(self.device) for d in ds], self.tcfg,
                                self.mesh)

    def save(self, epoch: int) -> None:
        if not self.rank0:
            return
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
        if self.mesh is not None:
            # every rank read the same bundles; rank 0's weights are the run's
            replicate(self.mesh, self.state.generator,
                      *self.state.discriminators)
        print(f" [*] Success to load model --> {cfg.pretrain_model_G} & "
              f"{cfg.pretrain_model_D}")
        return True, epoch

    def train(self, seed: Optional[int] = None) -> None:
        """The train loop; ``seed`` seeds the noise generator (default:
        drawn from numpy, as the JAX trainer draws its key)."""
        cfg = self.cfg
        if self.rank0:
            os.makedirs(os.path.join(cfg.checkpoint_dir, cfg.model_dir),
                        exist_ok=True)
            self._log_fout = open(os.path.join(
                cfg.checkpoint_dir, cfg.model_dir, cfg.log_info), "w")
            self._log_fout.write(str(cfg) + "\n")
        if self.state is None:
            self.build_model()
        could_load, save_epoch = self.load()
        start_epoch = save_epoch if could_load else 1
        if could_load:
            print(" [*] Load SUCCESS")
        else:
            print(f" [!] start epoch: {start_epoch}")

        dataset = self._make_dataset("train", "shape_unit")
        num_batches = len(dataset) // cfg.batch_size
        seed = seed if seed is not None else int(np.random.randint(0, 2 ** 31))
        rng = torch.Generator(device=self.device).manual_seed(seed)
        B, dev, sigma = cfg.batch_size, self.device, self.tcfg.noise_sigma
        rows = None if self.mesh is None else self.mesh.rows(B)

        start_time = time.time()
        global_step, prof = 0, None
        for epoch in range(start_epoch, cfg.max_epoch + 1):
            loader = train_loader(dataset, B, device=dev, rows=rows)
            idx = 0
            try:
                while not (cfg.max_steps_per_epoch
                           and idx >= cfg.max_steps_per_epoch):
                    t_wait = time.perf_counter()
                    batch = next(loader, None)
                    if batch is None:
                        break
                    t0 = time.perf_counter()
                    if cfg.profile_dir and global_step == 2 and self.rank0:
                        prof = self._start_trace()
                    noise = [sigma * torch.randn(B, cfg.noise_dim,
                                                 generator=rng, device=dev)
                             for _ in range(2)]
                    metrics = train_step(self.state, list(batch[:4]),
                                         *noise, self.tcfg)
                    m = {k: float(v) for k, v in metrics.items()}
                    self.wait_seconds.append(t0 - t_wait)
                    self.step_seconds.append(time.perf_counter() - t0)
                    self.last_metrics = m
                    if prof is not None and global_step == 4:
                        self._stop_trace(prof)
                        prof = None
                    global_step += 1
                    idx += 1
                    el = time.time() - start_time
                    self.log_string(
                        "Epoch: [%2d] [%4d/%4d] time: %2dm %2ds d_loss1: "
                        "%.8f d_loss2: %.8f d_loss3: %.8f d_loss4: %.8f, "
                        "g_loss: %.8f, similar_loss: %.8f"
                        % (epoch, idx, num_batches, el / 60, el % 60,
                           m["d_loss1"], m["d_loss2"], m["d_loss3"],
                           m["d_loss4"], m["g_loss"], m["similar_loss"]))
            finally:
                loader.close()
            if epoch % cfg.snapshot == 0:
                self.save(epoch)
        if prof is not None:
            self._stop_trace(prof)
        self.save(cfg.max_epoch)
        if self._log_fout is not None:
            self._log_fout.close()
            self._log_fout = None

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_trace(self, prof) -> str:
        """Ends the trace and writes it as a Chrome trace into
        ``profile_dir``; returns its path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            "train_steps_2_4.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"Profile trace of steps 2..4: {path}")
        return path

    def _load_for_eval(self) -> None:
        """Build the models if needed and restore the bundles, test-phase
        style: a missing checkpoint prints and the phase goes on (reference
        models/PDGNet_v2.py:281-285)."""
        if self.state is None:
            self.build_model()
        try:
            could_load, _ = self.load()
            print(" [*] Load SUCCESS" if could_load
                  else " [!] Load failed...")
        except FileNotFoundError as e:
            print(f" [!] Load failed... ({e})")

    def test(self, tile: int = 64) -> dict:
        """The test phase (reference models/PDGNet_v2.py:271-326): generate
        as many clouds as the dataset's test split holds (sigma=1 noise from ``seed``,
        batch-statistic BN, exact kNN graphs: the port has no other), save
        ``nonormal_out.npy``, renormalise, save ``out.npy``, score them
        against the test set with the metric suite in ``(tile, tile)``
        blocks of pairs, log each result and return them. Under a mesh
        every rank returns the matrices' metrics; rank 0's also hold JSD."""
        cfg = self.cfg
        self._load_for_eval()

        cate_tag = "_".join(cfg.choice) if cfg.choice else "full"
        save_dir = os.path.join(
            cfg.save_dir, "GEN_Ours_%s_%d" % (cate_tag, int(time.time())))
        if self.rank0:
            os.makedirs(save_dir, exist_ok=True)
            logger = get_logger("test", save_dir)
        else:
            logger = BlackHole()
        seed_all(cfg.seed)

        logger.info("Loading datasets...")
        test_dset = self._make_dataset("test", cfg.normalize)
        ref_pcs = test_dset.full_clouds()
        gen_pcs = generate(len(test_dset), cfg.batch_size, cfg.seed,
                           device=self.device, model=self.state.generator,
                           mesh=self.mesh)
        if self.rank0:
            np.save(os.path.join(save_dir, "nonormal_out.npy"), gen_pcs)
        if cfg.normalize is not None:
            gen_pcs = normalize_point_clouds(gen_pcs, cfg.normalize, logger)

        logger.info("Saving point clouds...")
        if self.rank0:
            np.save(os.path.join(save_dir, "out.npy"), gen_pcs)

        results = compute_all_metrics(gen_pcs, ref_pcs, cfg.batch_size,
                                      tile=tile, mesh=self.mesh,
                                      device=self.device)
        if not self.rank0:
            return results
        results["jsd"] = jsd_between_point_cloud_sets(gen_pcs, ref_pcs,
                                                      device=self.device)
        for k, v in results.items():
            logger.info("%s: %.12f" % (k, v))
        return results
