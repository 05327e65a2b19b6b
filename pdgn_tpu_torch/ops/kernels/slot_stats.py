"""Slot-blocked first/second moments of the lane-flat hidden activation
(port of pdgn_tpu/ops/pallas/slot_stats.py).

``h (B, N, k*H) -> s (H,), S (H, H)`` summed over every (batch, point,
slot) row; bn_all2's statistics follow through the linear identity in the
generator. CUDA tensors launch ``csrc/slot_stats.cu`` (H = 64, the
generator's width); CPU tensors run :func:`stats_plain`. The backward is one
product on either device, ``dh = h (dS + dS^T) + ds`` per (row, slot), as the
JAX package computes it outside its kernel (slot_stats.py:120-127).
"""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.kernels import _lib

_H = 64
_ROWS_PER_BLOCK = 1024


def stats_plain(h_flat: torch.Tensor, k: int):
    """Port of ``_jnp_stats``: one reshape and an fp32 product."""
    B, N, kh = h_flat.shape
    hf = h_flat.reshape(B * N * k, kh // k)
    return hf.sum(dim=0), torch.matmul(hf.T, hf)


def stats_kernel(h_flat: torch.Tensor, k: int):
    """Launch ``csrc/slot_stats.cu`` (CUDA tensors, checked by
    :func:`slot_moment_stats`)."""
    B, N, kh = h_flat.shape
    rows = B * N * k
    f32 = dict(device=h_flat.device, dtype=torch.float32)
    nblk = -(-rows // _ROWS_PER_BLOCK)
    scratch = torch.empty(nblk, _H * _H + _H, **f32)
    out = torch.empty(_H * _H + _H, **f32)
    _lib.check(_lib.library().pdgn_slot_stats(
        h_flat.data_ptr(), rows, scratch.data_ptr(), out.data_ptr(),
        _lib.stream_handle(h_flat.device)), "pdgn_slot_stats")
    _lib.LAUNCHES["slot_stats"] += 1
    return out[_H * _H:], out[:_H * _H].reshape(_H, _H)


def stats_bwd(h_flat: torch.Tensor, ds: torch.Tensor, dS: torch.Tensor):
    """``dh`` of ``(s, S)``: a ``(rows, H) @ (H, H)`` product plus ``ds``."""
    hf = h_flat.reshape(-1, ds.shape[0])
    return (torch.matmul(hf, dS + dS.T) + ds).reshape(h_flat.shape)


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
    """``(B, N, k*H) -> (s (H,), S (H, H))``, fp32 accumulation."""
    if h_flat.dim() != 3 or h_flat.shape[-1] % k:
        raise ValueError(f"slot_moment_stats: h must be (B, N, k*H), got "
                         f"{tuple(h_flat.shape)} with k={k}")
    if h_flat.dtype != torch.float32:
        raise TypeError(f"slot_moment_stats: expected float32, got "
                        f"{h_flat.dtype}")
    if not h_flat.is_contiguous():
        raise ValueError("slot_moment_stats: h must be contiguous")
    if h_flat.device.type == "cuda":
        if h_flat.shape[-1] != k * _H:
            raise ValueError(f"slot_stats kernel: hidden width must be {_H}")
    elif h_flat.device.type != "cpu":
        raise ValueError(f"slot_moment_stats: unsupported device "
                         f"{h_flat.device}")
    return _SlotStats.apply(h_flat, k)
