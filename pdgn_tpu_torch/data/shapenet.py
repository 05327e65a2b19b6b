"""Multi-resolution point-cloud data (port of pdgn_tpu/data/shapenet.py:
the synset maps, ``SCALE_MODES``, ``RESOLUTIONS``, ``normalize_cloud``,
``ShapeNetCore``, ``SyntheticShapes``, ``batch_iterator``).

Items are ``(p256, p512, p1024, p2048, category)`` numpy tuples at the
reference resolutions (each an eighth, quarter, half of the full cloud and
the cloud itself), batched on the host. ``ShapeNetCore`` reads the
shapenet15k hdf5 file through the port's own reader (``data.h5``).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pdgn_tpu_torch.data import h5

# Synset-id <-> category map (reference datasets_4point.py:240-263).
synsetid_to_cate = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "vessel",
    "04554684": "washer", "02992529": "cellphone",
    "02843684": "birdhouse", "02871439": "bookshelf",
}
cate_to_synsetid = {v: k for k, v in synsetid_to_cate.items()}

SCALE_MODES = (None, "global_unit", "shape_unit", "shape_bbox",
               "shape_half", "shape_34")

RESOLUTIONS = (256, 512, 1024, 2048)


def normalize_cloud(pc: np.ndarray, mode: Optional[str],
                    global_std: Optional[float] = None) -> np.ndarray:
    """Apply one scale mode to a single cloud (reference
    datasets_4point.py:332-353); standard deviations use ``ddof=1`` like
    torch's ``.std()``."""
    if mode == "global_unit":
        shift = pc.mean(axis=0, keepdims=True)
        scale = np.asarray(global_std).reshape(1, 1)
    elif mode == "shape_unit":
        shift = pc.mean(axis=0, keepdims=True)
        scale = pc.flatten().std(ddof=1).reshape(1, 1)
    elif mode == "shape_half":
        shift = pc.mean(axis=0, keepdims=True)
        scale = pc.flatten().std(ddof=1).reshape(1, 1) / 0.5
    elif mode == "shape_34":
        shift = pc.mean(axis=0, keepdims=True)
        scale = pc.flatten().std(ddof=1).reshape(1, 1) / 0.75
    elif mode == "shape_bbox":
        pc_max = pc.max(axis=0, keepdims=True)
        pc_min = pc.min(axis=0, keepdims=True)
        shift = (pc_min + pc_max) / 2.0
        scale = (pc_max - pc_min).max().reshape(1, 1) / 2.0
    else:
        shift = np.zeros((1, 3), pc.dtype)
        scale = np.ones((1, 1), pc.dtype)
    return (pc - shift) / scale


@dataclass
class _Item:
    pointcloud: np.ndarray
    cate: str
    id: int


class ShapeNetCore:
    """The shapenet15k hdf5 dataset with the reference's item semantics
    (datasets_4point.py:266-381): ``f[synsetid][split]`` clouds of the
    chosen categories (``"all"``: every one), each normalised by
    ``scale_mode``, stably sorted by in-split index and shuffled with
    ``random.Random(2020)`` (categories interleave); an item's three
    sub-resolutions are drawn with replacement (``choice(n, r)``) from
    numpy's global stream, or from ``RandomState(seed)``, in item order.
    The dataset's mean and std over all three splits are cached beside the
    file (``<name>_stats/stats_<synsetids>.npz``)."""

    def __init__(self, path: str, cates_list, split: str,
                 scale_mode: Optional[str], seed: Optional[int] = None):
        assert split in ("train", "val", "test")
        assert scale_mode in SCALE_MODES, scale_mode
        cates = ([cates_list] if isinstance(cates_list, str)
                 else list(cates_list))
        if "all" in cates:
            cates = list(cate_to_synsetid.keys())
        self.cate_synsetids = sorted(cate_to_synsetid[c] for c in cates)
        self.path = path
        self.split = split
        self.scale_mode = scale_mode
        self._rng = (np.random.RandomState(seed) if seed is not None
                     else np.random)
        self.stats = self._get_statistics()
        self.items: List[_Item] = []
        self._load()

    def _stats_path(self) -> str:
        basename = os.path.basename(self.path)
        dsetname = basename[: basename.rfind(".")]
        stats_dir = os.path.join(os.path.dirname(self.path),
                                 dsetname + "_stats")
        os.makedirs(stats_dir, exist_ok=True)
        if len(self.cate_synsetids) == len(cate_to_synsetid):
            return os.path.join(stats_dir, "stats_all.npz")
        return os.path.join(
            stats_dir, "stats_" + "_".join(self.cate_synsetids) + ".npz")

    def _get_statistics(self):
        """Mean and std (``ddof=1``, torch's ``.std()``) of every point of
        the categories' three splits (reference :291-319), cached."""
        stats_path = self._stats_path()
        if os.path.exists(stats_path):
            z = np.load(stats_path)
            return {"mean": z["mean"], "std": float(z["std"])}
        with h5.File(self.path) as f:
            clouds = [f[synsetid][split][...]
                      for synsetid in self.cate_synsetids
                      for split in ("train", "val", "test")]
        all_points = np.concatenate(clouds, axis=0)
        mean = all_points.reshape(-1, 3).mean(axis=0)
        std = all_points.reshape(-1).std(ddof=1)
        np.savez(stats_path, mean=mean, std=std)
        return {"mean": mean, "std": float(std)}

    def _load(self):
        with h5.File(self.path) as f:
            for synsetid in self.cate_synsetids:
                cate_name = synsetid_to_cate[synsetid]
                for j, pc in enumerate(f[synsetid][self.split][...]):
                    pc = normalize_cloud(
                        np.asarray(pc, np.float32), self.scale_mode,
                        self.stats["std"]).astype(np.float32)
                    self.items.append(_Item(pc, cate_name, j))
        self.items.sort(key=lambda it: it.id)
        random.Random(2020).shuffle(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        it = self.items[idx]
        n = it.pointcloud.shape[0]
        subs = [it.pointcloud[self._rng.choice(n, r)]   # with replacement
                for r in RESOLUTIONS[:3]]
        return (*subs, it.pointcloud, it.cate)

    def full_clouds(self) -> np.ndarray:
        """All full-resolution clouds, stacked (the test phase's reference
        set)."""
        return np.stack([it.pointcloud for it in self.items])


class SyntheticShapes:
    """Deterministic gaussian-mixture "shapes" with the dataset protocol
    (no hdf5 needed): cloud ``idx`` comes from its own seeded
    ``RandomState``; the sub-resolutions are drawn with replacement from the
    global numpy stream, as the reference's ``np.random.choice``. The
    clouds are made at construction, as ShapeNetCore loads its split, so
    the loader's thread only draws."""

    def __init__(self, size: int = 64, num_points: int = 2048,
                 cate: str = "synthetic", seed: int = 0):
        self.size = size
        self.num_points = num_points
        self.cate = cate
        self.seed = seed
        self._clouds = [self._make(idx) for idx in range(size)]

    def __len__(self) -> int:
        return self.size

    def _make(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        centers = rng.randn(4, 3).astype(np.float32) * 0.5
        assign = rng.randint(0, 4, self.num_points)
        pts = (centers[assign]
               + 0.15 * rng.randn(self.num_points, 3).astype(np.float32))
        return normalize_cloud(pts, "shape_unit").astype(np.float32)

    def __getitem__(self, idx: int):
        pc = self._clouds[idx]
        subs = [pc[np.random.choice(self.num_points, self.num_points >> s)]
                for s in (3, 2, 1)]
        return (*subs, pc, self.cate)

    def full_clouds(self) -> np.ndarray:
        """All full-resolution clouds, stacked (the test phase's reference
        set)."""
        return np.stack(self._clouds)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   drop_last: bool = True, seed: Optional[int] = None
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray, Tuple[str, ...]]]:
    """Host-side batches ``(p1, p2, p3, p4, cates)``; the trailing partial
    batch is dropped, as the reference trainer skips it
    (models/PDGNet_v2.py:169)."""
    order = np.arange(len(dataset))
    if shuffle:
        rng = np.random.RandomState(seed) if seed is not None else np.random
        rng.shuffle(order)
    n = len(dataset)
    stop = n - (n % batch_size) if drop_last else n
    for start in range(0, stop, batch_size):
        items = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield tuple(np.stack([it[r] for it in items]) for r in range(4)) + (
            tuple(it[4] for it in items),)
