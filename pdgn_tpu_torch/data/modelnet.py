"""ModelNet10/40 multi-resolution dataset (port of
pdgn_tpu/data/modelnet.py; reference ``ModelNetDataset``,
datasets_4point.py:120-237): reads the ``modelnet40_normal_resampled``
txt layout, takes the *first* 256/512/1024/2048 points of each cloud
(the reference slices, it does not sample), optionally normalises each
slice to the unit sphere, and caches loaded files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pdgn_tpu_torch.data import provider
from pdgn_tpu_torch.data.shapenet import RESOLUTIONS


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + unit-sphere scale (reference datasets_4point.py:112-118)."""
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt((pc ** 2).sum(axis=1)))
    return pc / m


class ModelNetDataset:
    """ModelNet10/40 loader with the reference's 4-resolution item protocol."""

    def __init__(
        self,
        root: str,
        batch_size: int = 50,
        split: str = "train",
        normalize: bool = True,
        normal_channel: bool = False,
        modelnet10: bool = False,
        cache_size: int = 15000,
        shuffle: Optional[bool] = None,
        class_choice: Optional[str] = None,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.root = os.path.join(root, "modelnet40_normal_resampled")
        self.batch_size = batch_size
        self.normalize = normalize
        self.normal_channel = normal_channel
        prefix = "modelnet10" if modelnet10 else "modelnet40"
        self.catfile = os.path.join(self.root, f"{prefix}_shape_names.txt")
        with open(self.catfile) as f:
            self.cat = [line.rstrip() for line in f]
        self.classes = dict(zip(self.cat, range(len(self.cat))))

        assert split in ("train", "test")
        with open(os.path.join(self.root, f"{prefix}_{split}.txt")) as f:
            shape_ids = [line.rstrip() for line in f]
        shape_names = ["_".join(x.split("_")[0:-1]) for x in shape_ids]
        self.datapath = [
            (shape_names[i],
             os.path.join(self.root, shape_names[i], shape_ids[i]) + ".txt")
            for i in range(len(shape_ids))
        ]
        if class_choice is not None:
            self.datapath = [d for d in self.datapath if d[0] == class_choice]
        self.cache_size = cache_size
        self.cache = {}
        # reference default: shuffle the epoch order for train only
        # (datasets_4point.py:152-157)
        self.shuffle = (split == "train") if shuffle is None else shuffle
        self._rng = rng  # None -> provider's module-level numpy RNG
        self.reset()

    def __len__(self) -> int:
        return len(self.datapath)

    def __getitem__(self, index: int):
        if index in self.cache:
            point_set, cls = self.cache[index]
        else:
            name, path = self.datapath[index]
            cls = np.array([self.classes[name]], np.int32)
            point_set = np.loadtxt(path, delimiter=",").astype(np.float32)
            if len(self.cache) < self.cache_size:
                self.cache[index] = (point_set, cls)
        slices = []
        for r in RESOLUTIONS:
            ps = point_set[:r, :].copy()
            if self.normalize:
                ps[:, 0:3] = pc_normalize(ps[:, 0:3])
            if not self.normal_channel:
                ps = ps[:, 0:3]
            slices.append(ps)
        return (*slices, cls)

    def num_channel(self) -> int:
        """Reference datasets_4point.py:211-215."""
        return 6 if self.normal_channel else 3

    def reset(self) -> None:
        """Start a new epoch: reshuffle the index order, rewind the batch
        cursor (reference datasets_4point.py:217-222)."""
        self.idxs = np.arange(0, len(self.datapath))
        if self.shuffle:
            (self._rng if self._rng is not None else np.random
             ).shuffle(self.idxs)
        self.num_batches = ((len(self.datapath) + self.batch_size - 1)
                            // self.batch_size)
        self.batch_idx = 0

    def has_next_batch(self) -> bool:
        """Reference datasets_4point.py:224-225."""
        return self.batch_idx < self.num_batches

    def _augment_batch_data(self, batch_data: np.ndarray) -> np.ndarray:
        """Train-time augmentation chain (reference datasets_4point.py:
        161-174): rotate (+ perturbation), then scale/shift/jitter on the
        xyz channels, then shuffle point order."""
        if self.normal_channel:
            rotated = provider.rotate_point_cloud_with_normal(
                batch_data, rng=self._rng)
            rotated = provider.rotate_perturbation_point_cloud_with_normal(
                rotated, rng=self._rng)
        else:
            rotated = provider.rotate_point_cloud(batch_data, rng=self._rng)
            rotated = provider.rotate_perturbation_point_cloud(
                rotated, rng=self._rng)
        xyz = provider.random_scale_point_cloud(
            rotated[:, :, 0:3], rng=self._rng)
        xyz = provider.shift_point_cloud(xyz, rng=self._rng)
        xyz = provider.jitter_point_cloud(xyz, rng=self._rng)
        rotated[:, :, 0:3] = xyz
        return provider.shuffle_points(rotated, rng=self._rng)

    def next_batch(self, augment: bool = False):
        """Next ``(batch_data, batch_label)``; the last batch of an epoch
        may be smaller than ``batch_size``.

        Matches the intent of reference datasets_4point.py:227-240. (The
        reference's own ``next_batch`` is dead code — it reads a
        nonexistent ``self.npoints`` and 2-unpacks ``_get_item``'s
        5-tuple — so this returns the evident design: the full-resolution
        cloud per item, i.e. the RESOLUTIONS[-1] slice.)
        """
        start = self.batch_idx * self.batch_size
        end = min((self.batch_idx + 1) * self.batch_size, len(self.datapath))
        bsize = end - start
        batch_data = np.zeros(
            (bsize, RESOLUTIONS[-1], self.num_channel()), np.float32)
        batch_label = np.zeros((bsize,), np.int32)
        for i in range(bsize):
            item = self[int(self.idxs[start + i])]
            batch_data[i] = item[3]
            batch_label[i] = item[4][0]
        self.batch_idx += 1
        if augment:
            batch_data = self._augment_batch_data(batch_data)
        return batch_data, batch_label

    def full_clouds(self) -> np.ndarray:
        return np.stack([self[i][3] for i in range(len(self))])
