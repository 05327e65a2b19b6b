"""Build and load the port's CUDA kernels.

Every ``pdgn_tpu_torch/csrc/*.cu`` file compiles with ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, started together), and the
objects link into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``pdgn_tpu_torch/_build/`` under a name that
carries a hash of the sources and flags, so an edited source rebuilds on
first use and an unchanged one loads at once. Nothing here runs at import:
the first kernel launch builds.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel on a CUDA tensor, and nowhere else; the CPU route (the
plain version) never touches it. A bf16 instance counts under its kernel's
name with ``_bf16`` appended.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# argument types of every exported C function (pointers and the stream as
# c_void_p: ctypes would otherwise pass a 32-bit int and cut the pointer)
_SIGNATURES = {
    "pdgn_edge_head": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I]
                      + [_P] * 11 + [_P, _I, _I, _P, _P, _P],
    "pdgn_edge_head_bf16": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I]
                           + [_P] * 11 + [_I, _P, _P, _P, _P],
    "pdgn_slot_stats": [_P, _L, _I, _P, _P, _P],
    "pdgn_slot_stats_bf16": [_P, _L, _I, _P, _P, _P],
    "pdgn_bilateral_tail": [_P] * 10 + [_I, _P] + [_I] * 6 + [_P] * 3,
    "pdgn_bilateral_tail_plain_bf16": [_P] * 5 + [_I, _P] + [_I] * 5
                                      + [_P] * 3,
    "pdgn_bilateral_tail_gated_bf16": [_P] * 11 + [_I] * 6 + [_P] * 3,
    "pdgn_edge_head_bwd": [_P] * 4 + [_I] * 8 + [_P] * 10 + [_P] * 15
                          + [_P],
    "pdgn_edge_head_bwd_bf16": [_P] * 4 + [_I] * 8 + [_P] * 11
                               + [_P] * 8 + [_P] * 13 + [_I] * 6 + [_P],
    "pdgn_bilateral_tail_bwd": [_P] * 12 + [_I] * 8 + [_P] * 12 + [_P],
    "pdgn_bilateral_tail_bwd_bf16": [_P] * 11 + [_I] * 8 + [_P] * 12 + [_P],
    "pdgn_bilateral_tail_gated_bwd_bf16": [_P] * 11 + [_I] * 11 + [_P] * 11
                                          + [_P],
    "pdgn_local_stats_fwd": [_P, _P, _I, _I, _I, _I] + [_P] * 5 + [_P],
    "pdgn_local_stats_bwd": [_P] * 7 + [_I] * 4 + [_P, _P],
    "pdgn_emd_cd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                    _P],
    "pdgn_knn_topk": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "pdgn_knn_gather": [_P, _I, _I, _I, _I, _P, _P, _P],
    "pdgn_tc_gemm": [_P, _I, _P] + [_I] * 5 + [_P] * 5,
    "pdgn_product_bf16": [_P, _P] + [_I] * 4 + [_P] * 3,
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "pdgn_tpu_torch's kernels")


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources into ``_build/libpdgn_kernels_<hash>.so`` unless
    that file exists; returns its path. A file lock serialises concurrent
    builds."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    headers = sorted(SRC_DIR.glob("*.cuh"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    tag = _digest(sources + headers)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libpdgn_kernels_{tag}.so"
    if so.is_file():
        return so
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.is_file():
            return so
        nvcc = _nvcc()
        objs = []
        procs = []
        for src in sources:
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = so.with_suffix(".so.tmp")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        tmp.rename(so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
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


# a grid's y dimension holds at most 65535 blocks: the tensor-core product
# core (csrc/tf32x3_gemm.cuh) puts 128-row tiles there; the tail gates'
# grids (16-point tiles) loop over what is left
MAX_GRID_Y = 65535
# rows per split of the transposed (weight-gradient) products: kSplitRows in
# csrc/tf32x3_gemm.cuh; their scratch holds one (M, N) partial per split
TN_SPLIT_ROWS = 4096


def product_splits(tiles: int, stages: int, sms: int) -> int:
    """Row splits of a transposed bf16 product (``product_bf16_kernel`` in
    ``csrc/hopper.cuh``): about two blocks an SM over its ``tiles`` output
    tiles, at most one a stage of 64 rows. Split ``z`` takes the stages
    ``z * stages // splits`` up to ``(z + 1) * stages // splits``."""
    return max(1, min(-(-2 * sms // tiles), stages))


def up4(v: int) -> int:
    """``v`` rounded up to a multiple of 4 (the products' 16-byte
    ``cp.async`` granules)."""
    return -(-v // 4) * 4


def up8(v: int) -> int:
    """``v`` rounded up to a multiple of 8 (a 16-byte granule of bf16)."""
    return -(-v // 8) * 8


def up64(v: int) -> int:
    """``v`` rounded up to a multiple of 64 (a 128-byte row of bf16: the
    bf16 head's slab of one neighbour slot)."""
    return -(-v // 64) * 64


def instance(t) -> str:
    """The kernel instance a tensor's dtype takes: ``""`` for float32,
    ``"_bf16"`` for bfloat16 (the suffix of its C entry and of its
    ``LAUNCHES`` name); any other dtype raises."""
    import torch

    if t.dtype == torch.float32:
        return ""
    if t.dtype == torch.bfloat16:
        return "_bf16"
    raise TypeError(f"no kernel instance for {t.dtype}: float32 or bfloat16")


def check_rows(rows: int, per_block: int, name: str) -> None:
    """Raise if ``rows`` need more than ``MAX_GRID_Y`` blocks of
    ``per_block`` rows (a batch too large for one launch)."""
    if -(-rows // per_block) > MAX_GRID_Y:
        raise ValueError(f"{name}: {rows} rows exceed one launch; use a "
                         f"smaller batch")


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} failed with CUDA error {status}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (the persistent grids' size)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(t):
    """``t``, or a copy of it if its data is not 16-byte aligned (the
    kernels stage operands by 16-byte ``cp.async`` copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t) -> int | None:
    """Device pointer of a contiguous tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()
