"""Host-side point-cloud batch augmentations (port of
pdgn_tpu/data/provider.py, reference utils/provider.py): the same numpy
batch transforms, every random draw from an explicit
``numpy.random.RandomState`` (or numpy's global stream when ``rng`` is
omitted), and ``load_h5`` through the port's hdf5 reader.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pdgn_tpu_torch.data import h5


def _rng(rng: Optional[np.random.RandomState]):
    return rng if rng is not None else np.random


def shuffle_data(data: np.ndarray, labels: np.ndarray,
                 rng: Optional[np.random.RandomState] = None):
    """Shuffle clouds and labels jointly (reference provider.py:10-19)."""
    idx = np.arange(len(labels))
    _rng(rng).shuffle(idx)
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch_data: np.ndarray,
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Shuffle point order within each cloud (reference provider.py:22-31).

    Uses one permutation for the whole batch, as the reference does.
    """
    idx = np.arange(batch_data.shape[1])
    _rng(rng).shuffle(idx)
    return batch_data[:, idx, :]


def _rotate(batch_data: np.ndarray, angles: np.ndarray, axis: str) -> np.ndarray:
    out = np.zeros_like(batch_data)
    for k in range(batch_data.shape[0]):
        c, s = np.cos(angles[k]), np.sin(angles[k])
        if axis == "y":
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        else:  # z
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        out[k] = batch_data[k] @ R
    return out.astype(batch_data.dtype)


def rotate_point_cloud(batch_data: np.ndarray,
                       rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Random rotation about the (up) y axis (reference provider.py:34-53)."""
    angles = _rng(rng).uniform(size=batch_data.shape[0]) * 2 * np.pi
    return _rotate(batch_data, angles, "y")


def rotate_point_cloud_z(batch_data: np.ndarray,
                         rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Random rotation about the z axis (reference provider.py:55-74)."""
    angles = _rng(rng).uniform(size=batch_data.shape[0]) * 2 * np.pi
    return _rotate(batch_data, angles, "z")


def rotate_point_cloud_by_angle(batch_data: np.ndarray,
                                rotation_angle: float) -> np.ndarray:
    """Fixed-angle y rotation (reference provider.py:125-143)."""
    angles = np.full(batch_data.shape[0], rotation_angle)
    return _rotate(batch_data, angles, "y")


def rotate_perturbation_point_cloud(
    batch_data: np.ndarray,
    angle_sigma: float = 0.06,
    angle_clip: float = 0.18,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Small random xyz-euler perturbations (reference provider.py:170-193)."""
    r = _rng(rng)
    out = np.zeros_like(batch_data)
    for k in range(batch_data.shape[0]):
        a = np.clip(angle_sigma * r.randn(3), -angle_clip, angle_clip)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        R = Rz @ Ry @ Rx
        out[k] = batch_data[k] @ R
    return out.astype(batch_data.dtype)


def rotate_point_cloud_with_normal(batch_xyz_normal: np.ndarray,
                                   rng: Optional[np.random.RandomState] = None
                                   ) -> np.ndarray:
    """y rotation of xyz + normals (reference provider.py:76-95)."""
    r = _rng(rng)
    for k in range(batch_xyz_normal.shape[0]):
        angle = r.uniform() * 2 * np.pi
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        batch_xyz_normal[k, :, 0:3] = batch_xyz_normal[k, :, 0:3] @ R
        batch_xyz_normal[k, :, 3:6] = batch_xyz_normal[k, :, 3:6] @ R
    return batch_xyz_normal


def rotate_perturbation_point_cloud_with_normal(
    batch_data: np.ndarray,
    angle_sigma: float = 0.06,
    angle_clip: float = 0.18,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Perturbation of xyz + normals (reference provider.py:97-123)."""
    r = _rng(rng)
    out = np.zeros_like(batch_data)
    for k in range(batch_data.shape[0]):
        a = np.clip(angle_sigma * r.randn(3), -angle_clip, angle_clip)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        R = Rz @ Ry @ Rx
        out[k, :, 0:3] = batch_data[k, :, 0:3] @ R
        out[k, :, 3:6] = batch_data[k, :, 3:6] @ R
    return out.astype(batch_data.dtype)


def jitter_point_cloud(batch_data: np.ndarray, sigma: float = 0.01,
                       clip: float = 0.05,
                       rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Per-point gaussian jitter (reference provider.py:196-207)."""
    assert clip > 0
    noise = np.clip(sigma * _rng(rng).randn(*batch_data.shape), -clip, clip)
    return (batch_data + noise).astype(batch_data.dtype)


def shift_point_cloud(batch_data: np.ndarray, shift_range: float = 0.1,
                      rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Per-cloud random translation (reference provider.py:209-221)."""
    B = batch_data.shape[0]
    shifts = _rng(rng).uniform(-shift_range, shift_range, (B, 3))
    return (batch_data + shifts[:, None, :]).astype(batch_data.dtype)


def random_scale_point_cloud(batch_data: np.ndarray, scale_low: float = 0.8,
                             scale_high: float = 1.25,
                             rng: Optional[np.random.RandomState] = None
                             ) -> np.ndarray:
    """Per-cloud random scale (reference provider.py:223-234)."""
    B = batch_data.shape[0]
    scales = _rng(rng).uniform(scale_low, scale_high, B)
    return (batch_data * scales[:, None, None]).astype(batch_data.dtype)


def random_point_dropout(batch_pc: np.ndarray, max_dropout_ratio: float = 0.875,
                         rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Random point dropout, dropped points replaced by the first point
    (reference provider.py:236-243)."""
    r = _rng(rng)
    out = batch_pc.copy()
    for b in range(batch_pc.shape[0]):
        dropout_ratio = r.random_sample() * max_dropout_ratio
        drop_idx = np.where(r.random_sample(batch_pc.shape[1]) <= dropout_ratio)[0]
        if len(drop_idx) > 0:
            out[b, drop_idx, :] = out[b, 0, :]
    return out


def load_h5(h5_filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load (data, label) from an h5 file (reference provider.py:249-253)."""
    with h5.File(h5_filename) as f:
        return f["data"][:], f["label"][:]


def getDataFiles(list_filename: str):
    """Read a file-of-filenames list (reference provider.py:246-247)."""
    with open(list_filename) as f:
        return [line.rstrip() for line in f]


loadDataFile = load_h5
