"""Fused Chamfer + approximate EMD over every pair of two cloud sets (port
of pdgn_tpu/ops/pallas/emd_cd.py::fused_cd_emd), the evaluation suite's
pairwise kernel.

:func:`emd_cd` takes the sets ``a (S, n, 3)`` and ``b (R, n, 3)`` and
returns ``cd (S, R)`` (``dl.mean + dr.mean``) and the un-normalised
approxmatch ``cost (S, R)`` (divide by n for EMD). CUDA tensors launch
``csrc/emd_cd.cu`` (one block per pair; no pair copies, nothing of size
n x m in device memory). CPU tensors run the plain version,
:func:`emd_cd_plain`: ``chamfer_cd`` and ``match_cost`` over the broadcast
pairs, which materialises several ``(S*R, n, n)`` fp32 matrices. The TPU
kernel's ``n % 256`` rule (its VMEM row tile) is dropped: the kernel takes
any n up to :data:`MAX_POINTS`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pdgn_tpu_torch.losses.chamfer import chamfer_cd
from pdgn_tpu_torch.losses.emd import match_cost
from pdgn_tpu_torch.ops.kernels import _lib

# both clouds and four mass vectors (5 floats a point each side, plus the
# block's 512-float reduction scratch) in one block's 227 KB shared memory:
# (5 * 2n + 512) * 4 bytes <= 232,448
MAX_POINTS = 5760


def emd_cd_plain(a: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``chamfer_cd`` and ``match_cost`` of every pair."""
    S, n, _ = a.shape
    R = b.shape[0]
    pa = a[:, None].expand(S, R, n, 3).reshape(S * R, n, 3)
    pb = b[None, :].expand(S, R, n, 3).reshape(S * R, n, 3)
    with torch.no_grad():
        cd = chamfer_cd(pa, pb)
        cost = match_cost(pa, pb)
    return cd.reshape(S, R), cost.reshape(S, R)


def emd_cd_kernel(a: torch.Tensor,
                  b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/emd_cd.cu`` on contiguous fp32 CUDA sets."""
    S, n, _ = a.shape
    R, m = b.shape[0], b.shape[1]
    cd = torch.empty(S, R, device=a.device, dtype=torch.float32)
    cost = torch.empty(S, R, device=a.device, dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_emd_cd(
        p(a), p(b), S, R, n, m, p(cd), p(cost), _lib.stream_handle(a.device)),
        "pdgn_emd_cd")
    _lib.LAUNCHES["emd_cd"] += 1
    return cd, cost


def emd_cd(a: torch.Tensor,
           b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cd (S, R)`` and approxmatch ``cost (S, R)`` of every pair
    ``(a[s], b[r])``; ``a (S, n, 3)``, ``b (R, n, 3)`` fp32. CUDA tensors
    launch the kernel, CPU tensors run the plain version; anything else
    raises."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3:
        raise ValueError(f"emd_cd: need a (S,n,3), b (R,n,3); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"emd_cd assumes n == m (the reference test path), "
                         f"got {a.shape[1]} vs {b.shape[1]}")
    if a.shape[0] < 1 or b.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError("emd_cd: empty cloud set")
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    a, b = a.contiguous(), b.contiguous()
    if a.device.type == "cuda":
        if a.shape[1] > MAX_POINTS:
            raise ValueError(f"emd_cd kernel: at most {MAX_POINTS} points")
        return emd_cd_kernel(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"emd_cd: unsupported device {a.device}")
    return emd_cd_plain(a, b)
