"""ShapeNet-part (.pts/.seg) multi-resolution dataset (port of
pdgn_tpu/data/partdataset.py; reference ``PartDataset``,
datasets_4point.py:20-110): reads the ``synsetoffset2category.txt``
layout, 90/10 train split by sorted filename, and serves random
256/512/1024/2048 subsets (without replacement when the cloud is large
enough, with replacement otherwise — matching the reference's
``np.random.choice`` replace flag at :83-91).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pdgn_tpu_torch.data.shapenet import RESOLUTIONS


class PartDataset:
    def __init__(
        self,
        root: str,
        batch_size: int = 50,
        classification: bool = False,
        class_choice: Optional[str] = None,
        train: bool = True,
    ):
        self.root = root
        self.batch_size = batch_size
        self.classification = classification
        self.catfile = os.path.join(root, "synsetoffset2category.txt")
        self.cat = {}
        with open(self.catfile) as f:
            for line in f:
                ls = line.strip().split()
                self.cat[ls[0]] = ls[1]
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items() if k in class_choice}

        self.meta = {}
        for item in self.cat:
            self.meta[item] = []
            dir_point = os.path.join(root, self.cat[item], "points")
            dir_seg = os.path.join(root, self.cat[item], "points_label")
            fns = sorted(os.listdir(dir_point))
            fns = fns[: int(len(fns) * 0.9)] if train else fns[int(len(fns) * 0.9):]
            for fn in fns:
                token = os.path.splitext(os.path.basename(fn))[0]
                self.meta[item].append(
                    (os.path.join(dir_point, token + ".pts"),
                     os.path.join(dir_seg, token + ".seg"))
                )
        self.datapath = [
            (item, fn[0], fn[1]) for item in self.cat for fn in self.meta[item]
        ]
        self.classes = dict(zip(sorted(self.cat), range(len(self.cat))))
        self.num_seg_classes = 0
        if not self.classification:
            for i in range(len(self.datapath) // self.batch_size):
                l = len(np.unique(np.loadtxt(self.datapath[i][-1]).astype(np.uint8)))
                self.num_seg_classes = max(self.num_seg_classes, l)

    def __len__(self) -> int:
        return len(self.datapath)

    def __getitem__(self, index: int):
        item, pts_path, seg_path = self.datapath[index]
        cls = self.classes[item]
        point_set = np.loadtxt(pts_path).astype(np.float32)
        seg = np.loadtxt(seg_path).astype(np.int64)
        replace = len(seg) <= RESOLUTIONS[3]
        choices = [
            np.random.choice(len(seg), r, replace=replace) for r in RESOLUTIONS
        ]
        subsets = [point_set[c, :] for c in choices]
        seg = seg[choices[2]]
        if self.classification:
            return (*subsets, np.array([cls], np.int64))
        return (*subsets, seg)
