"""Slot-blocked first/second moments of the lane-flat hidden activation
(port of pdgn_tpu/ops/pallas/slot_stats.py).

``h (B, N, k*H) -> s (H,), S (H, H)`` summed over every (batch, point,
slot) row; bn_all2's statistics follow through the linear identity in the
generator. CUDA tensors launch ``csrc/slot_stats.cu`` (H = 64, the
generator's width; its fp32 or its bf16 instance, by ``h``'s dtype); CPU
tensors run :func:`stats_plain`. ``s`` and ``S`` are fp32 either way (bf16
products are exact in fp32). The backward is one product on either device,
``dh = h (dS + dS^T) + ds`` per (row, slot), as the JAX package computes it
outside its kernel (slot_stats.py:120-127): on the fp32 upcast of a bf16
``h``, ``dh`` rounded to ``h``'s dtype.
"""

from __future__ import annotations

import torch

from pdgn_tpu_torch.models.layers import upcast
from pdgn_tpu_torch.ops.kernels import _lib

_H = 64


def stats_plain(h_flat: torch.Tensor, k: int):
    """Port of ``_jnp_stats``: one reshape and an fp32 product (of the fp32
    upcast of a bf16 ``h``)."""
    B, N, kh = h_flat.shape
    hf = upcast(h_flat).reshape(B * N * k, kh // k)
    return hf.sum(dim=0), torch.matmul(hf.T, hf)


def stats_kernel(h_flat: torch.Tensor, k: int):
    """Launch ``csrc/slot_stats.cu`` (CUDA tensors, checked by
    :func:`slot_moment_stats`)."""
    B, N, kh = h_flat.shape
    rows = B * N * k
    dev = h_flat.device
    f32 = dict(device=dev, dtype=torch.float32)
    h = _lib.aligned(h_flat)
    nblk = _lib.sm_count(dev)          # a persistent grid, a block an SM
    scratch = torch.empty(nblk, _H * _H + _H, **f32)
    out = torch.empty(_H * _H + _H, **f32)
    sfx = _lib.instance(h)
    _lib.check(getattr(_lib.library(), "pdgn_slot_stats" + sfx)(
        h.data_ptr(), rows, nblk, scratch.data_ptr(), out.data_ptr(),
        _lib.stream_handle(dev)), "pdgn_slot_stats" + sfx)
    _lib.LAUNCHES["slot_stats" + sfx] += 1
    return out[_H * _H:], out[:_H * _H].reshape(_H, _H)


def stats_bwd(h_flat: torch.Tensor, ds: torch.Tensor, dS: torch.Tensor):
    """``dh`` of ``(s, S)``: a ``(rows, H) @ (H, H)`` product plus ``ds``,
    in fp32 (of the upcast of a bf16 ``h``), returned in ``h``'s dtype."""
    hf = upcast(h_flat).reshape(-1, ds.shape[0])
    dh = (torch.matmul(hf, dS + dS.T) + ds).reshape(h_flat.shape)
    return dh.to(h_flat.dtype)


class _SlotStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_flat, k):
        ctx.save_for_backward(h_flat)
        if h_flat.device.type == "cuda":
            return stats_kernel(h_flat, k)
        return stats_plain(h_flat, k)

    @staticmethod
    def backward(ctx, ds, dS):
        (h_flat,) = ctx.saved_tensors
        return stats_bwd(h_flat, ds, dS), None


def slot_moment_stats(h_flat: torch.Tensor, k: int):
    """``(B, N, k*H) -> (s (H,), S (H, H))``, fp32 accumulation; ``h``
    float32 or bfloat16 (or, on the CPU, float64: an arbiter's dtype)."""
    if h_flat.dim() != 3 or h_flat.shape[-1] % k:
        raise ValueError(f"slot_moment_stats: h must be (B, N, k*H), got "
                         f"{tuple(h_flat.shape)} with k={k}")
    if h_flat.dtype not in (torch.float32, torch.bfloat16) and not (
            h_flat.dtype == torch.float64 and h_flat.device.type == "cpu"):
        raise TypeError(f"slot_moment_stats: expected float32 or bfloat16, "
                        f"got {h_flat.dtype}")
    if not h_flat.is_contiguous():
        raise ValueError("slot_moment_stats: h must be contiguous")
    if h_flat.device.type == "cuda":
        if h_flat.shape[-1] != k * _H:
            raise ValueError(f"slot_stats kernel: hidden width must be {_H}")
    elif h_flat.device.type != "cpu":
        raise ValueError(f"slot_moment_stats: unsupported device "
                         f"{h_flat.device}")
    return _SlotStats.apply(h_flat, k)
