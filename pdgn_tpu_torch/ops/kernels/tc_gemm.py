"""The port's products on their own: the shared fp32-accurate tensor-core
product core (``csrc/tf32x3_gemm.cuh``, 3xTF32) and the bf16 ``wgmma``
product of ``csrc/hopper.cuh`` (``product_bf16_kernel``).

The gated tail's merge and the head's forward and fp32 backward products
run on the core inside their kernels; :func:`tc_matmul` launches it alone,
so that a check can hold its folded chains against float64 and a yardstick
can set one product against ``torch.addmm``. The bf16 head backward's
weight gradients run on the ``wgmma`` product with both operands MN-major;
:func:`product_bf16` launches it alone (``a.T @ b`` over the rows), so
that a check can hold its transposed layout against ``torch.mm``. CUDA
tensors launch the kernels (``csrc/tc_gemm.cu``); CPU tensors run the plain
PyTorch products.
"""

from __future__ import annotations

import torch

from pdgn_tpu_torch.ops.kernels import _lib


def matmul_plain(a, b, addend=None, bias=None, trans: bool = False):
    out = (a.T if trans else a) @ b
    if addend is not None:
        out = addend + out
    return out if bias is None else out + bias


def tc_matmul(a, b, addend=None, bias=None, *, trans: bool = False):
    """``(addend + a @ b) + bias``, or ``a.T @ b`` with ``trans`` (a
    reduction over the rows of ``a`` and ``b``, in 4,096-row splits added
    in a fixed order), with the accumulators folded as in the port's
    kernels. 2-D float32 operands whose widths are multiples of 4."""
    for name, t in (("a", a), ("b", b), ("addend", addend), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or t.device != a.device):
            raise ValueError(f"tc_matmul: {name} must be float32 on "
                             f"{a.device}")
    if a.device.type != "cuda":
        return matmul_plain(a, b, addend, bias, trans)
    K, M = a.shape if trans else a.shape[::-1]
    N = b.shape[1]
    if b.shape[0] != K or a.shape[1] % 4 or N % 4 or (trans and (
            addend is not None or bias is not None)):
        raise ValueError(f"tc_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} (widths multiples of 4)")
    _lib.check_rows(M, 128, "tc_matmul")
    a, b = _lib.aligned(a.contiguous()), _lib.aligned(b.contiguous())
    out = torch.empty(M, N, device=a.device, dtype=torch.float32)
    scratch = None
    if trans:
        scratch = torch.empty(-(-K // _lib.TN_SPLIT_ROWS) * M * N,
                              device=a.device, dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_tc_gemm(
        p(a), a.shape[1], p(b), N, M, N, K, int(trans),
        p(None if addend is None else addend.contiguous()),
        p(None if bias is None else bias.contiguous()), p(out), p(scratch),
        _lib.stream_handle(a.device)), "pdgn_tc_gemm")
    _lib.LAUNCHES["tc_gemm"] += 1
    return out


def product_bf16(a, b):
    """``a.T @ b`` in fp32 for bf16 ``a (K, M)`` and ``b (K, N)`` (M and N
    multiples of 8): on a CUDA tensor ``product_bf16_kernel`` with both
    operands MN-major, the K rows in :func:`_lib.product_splits` contiguous
    ranges for the card, whose partials are added in a fixed order; on a
    CPU tensor the plain product of the upcasts."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or t.device != a.device:
            raise ValueError(f"product_bf16: {name} must be a 2-D bfloat16 "
                             f"tensor on {a.device}")
    K, M = a.shape
    N = b.shape[1]
    if b.shape[0] != K or M % 8 or N % 8:
        raise ValueError(f"product_bf16: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} (M, N multiples of 8)")
    if a.device.type != "cuda":
        return a.float().T @ b.float()
    splits = _lib.product_splits(-(-M // 128) * -(-N // 256), -(-K // 64),
                                 _lib.sm_count(a.device))
    a, b = _lib.aligned(a.contiguous()), _lib.aligned(b.contiguous())
    out = torch.empty(M, N, device=a.device, dtype=torch.float32)
    scratch = torch.empty(splits * M * N, device=a.device,
                          dtype=torch.float32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_product_bf16(
        p(a), p(b), K, M, N, splits, p(scratch), p(out),
        _lib.stream_handle(a.device)), "pdgn_product_bf16")
    _lib.LAUNCHES["product_bf16"] += 1
    return out
