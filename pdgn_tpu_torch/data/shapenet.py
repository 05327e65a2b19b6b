"""Multi-resolution point-cloud data (port of pdgn_tpu/data/shapenet.py:
``normalize_cloud``, ``SyntheticShapes``, ``batch_iterator``).

Items are ``(p256, p512, p1024, p2048, category)`` numpy tuples at the
reference resolutions (each an eighth, quarter, half of the full cloud and
the cloud itself), batched on the host. The shapenet15k and ModelNet hdf5
readers are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


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


class SyntheticShapes:
    """Deterministic gaussian-mixture "shapes" with the dataset protocol
    (no hdf5 needed): cloud ``idx`` comes from its own seeded
    ``RandomState``; the sub-resolutions are drawn with replacement from the
    global numpy stream, as the reference's ``np.random.choice``."""

    def __init__(self, size: int = 64, num_points: int = 2048,
                 cate: str = "synthetic", seed: int = 0):
        self.size = size
        self.num_points = num_points
        self.cate = cate
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def _cloud(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        centers = rng.randn(4, 3).astype(np.float32) * 0.5
        assign = rng.randint(0, 4, self.num_points)
        pts = (centers[assign]
               + 0.15 * rng.randn(self.num_points, 3).astype(np.float32))
        return normalize_cloud(pts, "shape_unit").astype(np.float32)

    def __getitem__(self, idx: int):
        pc = self._cloud(idx)
        subs = [pc[np.random.choice(self.num_points, self.num_points >> s)]
                for s in (3, 2, 1)]
        return (*subs, pc, self.cate)


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
