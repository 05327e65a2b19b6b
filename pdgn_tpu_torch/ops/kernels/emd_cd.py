"""Fused Chamfer + approximate EMD over every pair of two cloud sets (port
of pdgn_tpu/ops/pallas/emd_cd.py::fused_cd_emd), the evaluation suite's
pairwise kernel.

:func:`emd_cd` takes the sets ``a (S, n, 3)`` and ``b (R, n, 3)`` and
returns ``cd (S, R)`` (``dl.mean + dr.mean``) and the un-normalised
approxmatch ``cost (S, R)`` (divide by n for EMD). CUDA tensors launch
``csrc/emd_cd.cu`` (one block per pair; nothing of size n x m in device
memory) on the clouds in Morton order (:func:`morton_order`) with the boxes
of every 32 consecutive points (:func:`tile_boxes`), which let it skip the
exact zeros of the early rounds. CPU tensors run the plain version,
:func:`emd_cd_plain`: ``chamfer_cd`` and ``match_cost`` over the broadcast
pairs, which materialises several ``(S*R, n, n)`` fp32 matrices. The TPU
kernel's ``n % 256`` rule (its VMEM row tile) is dropped, and so is any
size limit: the kernel streams both clouds through shared memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pdgn_tpu_torch.losses.chamfer import chamfer_cd
from pdgn_tpu_torch.losses.emd import match_cost
from pdgn_tpu_torch.ops.kernels import _lib

BOX = 32          # points a culling box (kSub in csrc/emd_cd.cu)
_MORTON_BITS = 10  # bits a coordinate in the Morton code


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


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Bits 0..9 of ``v`` to bits 0, 3, .., 27."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_order(x: torch.Tensor) -> torch.Tensor:
    """``(S, n)`` int64: each cloud's points ordered by the Morton code of
    their coordinates quantised to 10 bits inside the cloud's bounding box
    (a stable sort: equal codes keep their order), so that consecutive
    points lie close together. Elementwise IEEE arithmetic: the same order
    on the CPU and the card."""
    lo = x.amin(dim=1, keepdim=True)
    span = (x.amax(dim=1, keepdim=True) - lo).clamp_min(1e-30)
    top = (1 << _MORTON_BITS) - 1
    q = ((x - lo) / span * top).to(torch.int64).clamp_(0, top)
    code = (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
            | (_spread3(q[..., 2]) << 2))
    return torch.argsort(code, dim=1, stable=True)


def tile_boxes(x: torch.Tensor) -> torch.Tensor:
    """``(S, ceil(n / BOX), 6)``: the lo xyz and hi xyz of every ``BOX``
    consecutive points of each cloud (the last box over what is left)."""
    S, n, _ = x.shape
    pad = -n % BOX
    if pad:
        x = torch.cat([x, x[:, -1:].expand(S, pad, 3)], dim=1)
    t = x.reshape(S, -1, BOX, 3)
    return torch.cat([t.amin(dim=2), t.amax(dim=2)], dim=-1).contiguous()


def emd_cd_kernel(a: torch.Tensor, b: torch.Tensor, *, cull: bool = True,
                  counts: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/emd_cd.cu`` on contiguous fp32 CUDA sets. ``cull=False``
    visits every element of rounds 1-8 too (the same bits, slower);
    ``counts``, a zeroed ``(2,)`` int64 tensor, receives the culling tests
    made and the sub-tiles they skipped."""
    S, n, _ = a.shape
    R, m = b.shape[0], b.shape[1]
    a = torch.gather(a, 1, morton_order(a)[..., None].expand(S, n, 3))
    b = torch.gather(b, 1, morton_order(b)[..., None].expand(R, m, 3))
    abox, bbox = tile_boxes(a), tile_boxes(b)
    dev = a.device
    masses = torch.empty(S * R * 2 * (n + m), device=dev, dtype=torch.float32)
    cd = torch.empty(S, R, device=dev, dtype=torch.float32)
    cost = torch.empty(S, R, device=dev, dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_emd_cd(
        p(a), p(b), p(abox), p(bbox), S, R, n, m, int(cull), p(masses),
        p(cd), p(cost), p(counts), _lib.stream_handle(dev)), "pdgn_emd_cd")
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
        return emd_cd_kernel(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"emd_cd: unsupported device {a.device}")
    return emd_cd_plain(a, b)
