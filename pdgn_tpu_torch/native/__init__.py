"""Native CPU oracles of the point ops (port of pdgn_tpu/native/).

``pdgn_ops.cpp`` follows the reference's CUDA kernels step by step in
scalar C++ on the host: knnquery (insertion sort, first-seen index on
ties), nndistance, approxmatch (9 rounds, integer-division multipliers,
double accumulators) and furthest point sampling from index 0. They are an
oracle independent of the port's torch code: tests and ``chip_smoke.py``
hold ``knn_topk``, ``emd_cd`` and ``ops.furthest_point_sample`` against
them. Nothing on a main path calls them.

The library is compiled with the system ``g++`` on first use, with the JAX
package's flags (``-shared -fPIC -O3 -std=c++17`` and nothing more, so that
its results equal that build's bit for bit), into ``pdgn_tpu_torch/_build/``
under a name that carries a hash of the source and the flags; a file lock
serialises concurrent builds, and the library is written to a temporary
file and renamed into place. It has a plain C interface, loaded with
``ctypes``.

The functions take CPU tensors of shape ``(b, n, 3)`` (converted to
contiguous float32) and raise on any other device: they never move a tensor
behind the caller's back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Tuple

import torch

_HERE = pathlib.Path(__file__).resolve().parent
SRC = _HERE / "pdgn_ops.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-shared", "-fPIC", "-O3", "-std=c++17")

_P = ctypes.c_void_p
_L = ctypes.c_int64

# pointers as c_void_p: ctypes would otherwise pass a 32-bit int and cut
# the pointer
_SIGNATURES = {
    "pdgn_knnquery": [_P, _P, _L, _L, _L, _L, _P, _P],
    "pdgn_nndistance": [_P, _P, _L, _L, _L, _P, _P],
    "pdgn_approxmatch": [_P, _P, _L, _L, _L, _P],
    "pdgn_fps": [_P, _L, _L, _L, _P],
}

_lock = threading.Lock()
_lib = None


def available() -> bool:
    """True where ``g++`` is found (the one thing the build needs)."""
    return shutil.which("g++") is not None


def build() -> pathlib.Path:
    """Compile ``pdgn_ops.cpp`` into ``_build/libpdgn_ops_<hash>.so``
    unless that file exists; returns its path. A failed compile raises
    with the compiler's output."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    so = BUILD_DIR / f"libpdgn_ops_{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native_lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.is_file():
            return so
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: it builds pdgn_tpu_torch's "
                               "native oracles")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError("g++ failed:\n" + out.stdout + out.stderr)
            os.replace(tmp, so)
        finally:
            if tmp.exists():
                tmp.unlink()
    return so


def library() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _cloud(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous float32 ``(b, n, 3)`` CPU tensor of at least
    one point; raises on another device or shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cpu":
        raise ValueError(f"{name} lies on {t.device}: the native oracles "
                         "are CPU functions (copy it with .cpu())")
    if t.dim() != 3 or t.shape[2] != 3 or t.shape[1] < 1:
        raise ValueError(f"{name}: (b, n >= 1, 3) expected, got "
                         f"{tuple(t.shape)}")
    return t.detach().to(torch.float32).contiguous()


def _batch(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: {a.shape[0]} and "
                         f"{b.shape[0]}")
    return a.shape[0]


def _run(name: str, *args) -> None:
    status = getattr(library(), name)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args))
    if status != 0:
        raise MemoryError(f"{name}: its scratch could not be allocated")


def knnquery_cpu(xyz: torch.Tensor, new_xyz: torch.Tensor, nsample: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``nsample`` nearest points of ``xyz (b, n, 3)`` to each of
    ``new_xyz (b, m, 3)`` (reference knnquery): ``idx (b, m, nsample)``
    int32 ascending, first-seen index on ties, and ``dist2`` float32 (slots
    beyond n hold index 0 and inf)."""
    xyz, new_xyz = _cloud("xyz", xyz), _cloud("new_xyz", new_xyz)
    b, n, m = _batch(xyz, new_xyz), xyz.shape[1], new_xyz.shape[1]
    if nsample < 0:
        raise ValueError(f"nsample {nsample} < 0")
    idx = torch.empty(b, m, nsample, dtype=torch.int32)
    dist2 = torch.empty(b, m, nsample, dtype=torch.float32)
    _run("pdgn_knnquery", xyz, new_xyz, b, n, m, nsample, idx, dist2)
    return idx, dist2


def nndistance_cpu(x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional nearest squared distances (reference nndistance.cu):
    ``dl (b, n)``, each x point's to y, and ``dr (b, m)``, each y point's
    to x."""
    x, y = _cloud("x", x), _cloud("y", y)
    b, n, m = _batch(x, y), x.shape[1], y.shape[1]
    dl = torch.empty(b, n, dtype=torch.float32)
    dr = torch.empty(b, m, dtype=torch.float32)
    _run("pdgn_nndistance", x, y, b, n, m, dl, dr)
    return dl, dr


def approxmatch_cpu(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The approxmatch transport cost of each pair (reference
    approxmatch.cu), ``(b,)`` float32, accumulated in double. Takes three
    ``n * m`` double arrays of scratch."""
    x1, x2 = _cloud("x1", x1), _cloud("x2", x2)
    b, n, m = _batch(x1, x2), x1.shape[1], x2.shape[1]
    cost = torch.empty(b, dtype=torch.float32)
    _run("pdgn_approxmatch", x1, x2, b, n, m, cost)
    return cost


def fps_cpu(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Furthest point sampling (reference sampling_cuda_kernel.cu): ``(b,
    m)`` int32, index 0 first, then each point furthest from those chosen
    (first maximum on ties)."""
    xyz = _cloud("xyz", xyz)
    if m < 1:
        raise ValueError(f"m {m} < 1")
    b, n = xyz.shape[:2]
    idx = torch.empty(b, m, dtype=torch.int32)
    _run("pdgn_fps", xyz, b, n, m, idx)
    return idx


__all__ = ["approxmatch_cpu", "available", "fps_cpu", "knnquery_cpu",
           "nndistance_cpu"]
