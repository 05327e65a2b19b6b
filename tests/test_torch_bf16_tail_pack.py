"""The fused bf16 gated tail's packed merge weight (``pack_tail_wi_bf16``):
a plain product over exactly that packing, with the gate laid out as the
card's kernel lays its A tiles (``g``'s columns permuted chunk outer, slot
inner: depth index ``(cc * k + s) * TAIL_CC + j`` holds ``g``'s column ``s *
2Fin + cc * TAIL_CC + j``, zero past 2Fin), held against ``tail_reference``
in bf16 within 1 ulp (both sum exact products in fp32 in other orders and
round once). A packing fault (a slot's block out of place, the pad in the
wrong place, ``wi^T`` laid out transposed) moves whole columns and shows
here before the card runs the kernel.
"""

import numpy as np
import pytest
import torch

from torch_port_util import bf16_ulps, one_torch_thread  # noqa: F401

from pdgn_tpu_torch.ops.kernels.bilateral_tail import (TAIL_CC,
                                                       gate_reference,
                                                       pack_tail_wi_bf16,
                                                       tail_reference)

BF = torch.bfloat16


def _operands(seed, B, N, k, two_fin, two_f):
    """The bf16 gated tail's operands from numpy: bf16 inte, h, w2k and wi,
    fp32 folds, partial and bias."""
    rng = np.random.RandomState(seed)
    hk, four_fin = k // 2, 2 * two_fin

    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale + shift).astype(np.float32))

    return (r(B, N, two_f), r(B, N, hk * four_fin).to(BF),
            r(B, N, k * 64, scale=0.5).to(BF),
            r(four_fin, scale=0.2, shift=1.0), r(four_fin, scale=0.1),
            r(64, two_fin, scale=0.125).to(BF), r(two_fin, scale=0.1),
            r(two_fin, scale=0.2, shift=1.0), r(two_fin, scale=0.1),
            r(hk * four_fin, two_f, scale=(hk * four_fin) ** -0.5).to(BF),
            r(two_f, scale=0.1), k, True)


def kernel_depth_order(k, two_fin):
    """The g column of every merge depth index of the kernel's A tiles, -1
    for the zero pad: chunks of TAIL_CC channels outer, slots inner."""
    cols = []
    for cc in range(-(-two_fin // TAIL_CC)):
        for s in range(k):
            for j in range(TAIL_CC):
                c = cc * TAIL_CC + j
                cols.append(s * two_fin + c if c < two_fin else -1)
    return torch.tensor(cols)


def packed_product(args, wi_packed):
    """y from the plain gate laid out in the kernel's depth order and the
    packed ``wi^T``: fp32 products of bf16 values, rounded once."""
    partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias, k, sm = args
    B, N, two_f = partial.shape
    two_fin = inte.shape[-1] // k
    g = gate_reference(inte, h, isc, ish, w2k, w2b, s2, t2, k, sm)
    g = g.reshape(B * N, k * two_fin).float()
    cols = kernel_depth_order(k, two_fin)
    a = torch.where(cols >= 0, g[:, cols.clamp_min(0)], 0.0)
    acc = a @ wi_packed.float().T
    return (partial + acc.reshape(B, N, two_f) + bias).to(BF)


CASES = [(1, 40, 10, 512, 64),     # stage 4's k and 2Fin, a cut N and 2F
         (2, 23, 18, 12, 30),      # k=18; one chunk, mostly pad
         (1, 37, 10, 65, 66)]      # 2Fin odd: a last chunk of one channel


@pytest.mark.parametrize("B,N,k,two_fin,two_f", CASES)
def test_packed_product_matches_reference(B, N, k, two_fin, two_f):
    args = _operands(B + N + k + two_fin, B, N, k, two_fin, two_f)
    wi = args[9]
    chunks = -(-two_fin // TAIL_CC)
    packed = pack_tail_wi_bf16(wi, k)
    assert packed.dtype == BF and packed.is_contiguous()
    assert tuple(packed.shape) == (two_f, chunks * k * TAIL_CC)
    # the pad of every slot's last chunk is zeros
    blocks = packed.reshape(two_f, chunks, k, TAIL_CC)
    assert not blocks[:, -1, :, two_fin - (chunks - 1) * TAIL_CC:].any()
    y = packed_product(args, packed)
    want = tail_reference(*args)
    assert y.dtype == want.dtype == BF and y.shape == want.shape
    assert bf16_ulps(y, want) <= 1.0


def _swap_slots(p, k, two_fin):
    """slots 0 and 1 of the first chunk exchanged"""
    b = p.reshape(p.shape[0], -1, k, TAIL_CC).clone()
    b[:, 0, [0, 1]] = b[:, 0, [1, 0]]
    return b.reshape(p.shape)


def _pad_first(p, k, two_fin):
    """each slot's last chunk with its pad before its channels"""
    b = p.reshape(p.shape[0], -1, k, TAIL_CC).clone()
    n = two_fin - (b.shape[1] - 1) * TAIL_CC
    b[:, -1] = torch.roll(b[:, -1], TAIL_CC - n, dims=-1)
    return b.reshape(p.shape)


def _transposed(p, k, two_fin):
    """wi^T's memory read as if it were laid out (depth, 2F)"""
    return p.T.contiguous().reshape(p.shape)


@pytest.mark.parametrize("fault", [_swap_slots, _pad_first, _transposed])
def test_packing_faults_show(fault):
    B, N, k, two_fin, two_f = CASES[2]
    args = _operands(B + N + k + two_fin, B, N, k, two_fin, two_f)
    packed = pack_tail_wi_bf16(args[9], k)
    want = tail_reference(*args)
    assert bf16_ulps(packed_product(args, packed), want) <= 1.0
    assert bf16_ulps(packed_product(args, fault(packed, k, two_fin)),
                     want) > 8.0
