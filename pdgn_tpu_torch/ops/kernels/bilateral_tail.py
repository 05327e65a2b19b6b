"""Edge-conv stage tail: BN fold + gate + merge (port of
pdgn_tpu/ops/pallas/bilateral_tail.py), forward and backward.

:func:`edge_conv_tail` keeps the JAX entry's interface, folds the batch
norms and permutes the merge weight's inte half into block order on the
parameter side (bilateral_tail.py:575-604, differentiable plain torch), and
hands the operands to :func:`tail`, a ``torch.autograd.Function``. For CUDA
tensors its forward launches ``csrc/bilateral_tail.cu`` and its backward
``csrc/bilateral_tail_bwd.cu`` (gated for stages 2-4, plain for stage 1);
for CPU tensors they run the plain PyTorch versions (:func:`tail_reference`
and autograd's VJP of it, :func:`tail_bwd_plain`).

bf16 ``inte`` (the generator's ``--compute_dtype bfloat16``) takes the
kernels' bf16 instances, with ``h`` in bf16, ``w2k`` and ``wi`` in fp32
(rounded to bf16 inside the function, so that their gradients stay fp32)
and the folds, ``partial`` and the bias in fp32; ``y`` is bf16.
Its backward is ``csrc/bilateral_tail_bwd.cu``'s bf16 instance on a CUDA
tensor and :func:`tail_bwd_plain_bf16`, written at the same rounding
points, on a CPU tensor: the TPU kernels' (``_gated_bwd_kernel``,
``_plain_bwd_kernel``), not those of autograd through the bf16 forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from pdgn_tpu_torch.models.layers import (cast, matmul_f32, round_bf16,
                                          upcast)
from pdgn_tpu_torch.ops.kernels import _lib

# the gated gate kernel's widest k (csrc/tail_gate.cuh, kGateMaxK): k + 1 <=
# 128, the graph's longest list; k <= 16 keeps its slots in registers
MAX_K = 126
# the slot logits' error on the tensor cores relative to |s2| (max|h|
# ||w2k[:, c]||_1 + |w2b[c]|): 3xTF32 keeps ~22 bits a product and the 24
# truncated additions of 8 k8 steps lose at most ~2^-18.2; 2^-17 leaves a
# factor 2
KINK_BOUND = 2.0 ** -17


# the bf16 instance's slot logits: bf16 products are exact in fp32, and two
# fp32 sums of the 64 of them (the tensor cores truncating, a plain product
# rounding) lie within 64 units of 2^-23 of sum |h w| of each other; 2^-16
# leaves a factor 2. Within it of 0, the bf16 backward and its plain
# version may take LeakyReLU's other branch (kink_mask)
KINK_BOUND_BF16 = 2.0 ** -16


def _leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def kink_mask(h_flat, w2k, w2b, s2, t2, k: int):
    """The slot-logit entries ``(B*N, k, 2Fin)`` of a bf16 tail whose
    bn_all2 input ``(h @ w2k + w2b) * s2 + t2`` lies within
    ``KINK_BOUND_BF16`` of ``|s2| (|h| @ |w2k| + |w2b|)`` of 0: where the
    bf16 backward instance and its plain version, each deciding the
    LeakyReLU branch from its own fp32 sum, may differ (the checks count
    these entries apart)."""
    h = upcast(h_flat).reshape(-1, k, h_flat.shape[-1] // k)
    w = upcast(w2k.to(torch.bfloat16))
    hat = (h @ w + w2b) * s2 + t2
    bnd = s2.abs() * (h.abs() @ w.abs() + w2b.abs()) * KINK_BOUND_BF16
    return hat.abs() <= bnd


def gate_reference(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, k: int,
                   softmax: bool):
    """The tail's gate ``g (B, N, k/2, 4Fin)`` on lane-flat operands: the
    BN-folded LeakyReLU of ``inte``, times the slot weights when ``h`` is
    given. With bf16 ``inte`` (and ``h``, ``w2k``) the first factor, the
    slot weights and their product are rounded to bf16, as in
    ``_reference``."""
    B, N, _ = inte_flat.shape
    hk = k // 2
    four_fin = inte_flat.shape[-1] // hk
    dt = torch.bfloat16 if inte_flat.dtype == torch.bfloat16 else None
    gi = cast(dt, _leaky(upcast(inte_flat.reshape(B, N, hk, four_fin)) * isc
                         + ish))
    if h_flat is not None:
        hidden = h_flat.shape[-1] // k
        h = h_flat.reshape(B, N, k, hidden)
        u = _leaky((matmul_f32(h, w2k) + w2b) * s2 + t2)
        if softmax:
            u = torch.softmax(u, dim=2)
        # slot pairs (2wp, 2wp+1) -> block channels (contiguous reshape)
        gi = gi * cast(dt, u.reshape(B, N, hk, four_fin))
    return gi


def tail_reference(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2,
                   wi, bias, k: int, softmax: bool):
    """Port of ``_reference``: the tail on lane-flat operands, the gate of
    :func:`gate_reference` through the merge. With bf16 operands the merge
    accumulates in fp32 and ``y`` is rounded to bf16, as there."""
    B, N, _ = partial.shape
    dt = torch.bfloat16 if inte_flat.dtype == torch.bfloat16 else None
    g = gate_reference(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, k,
                       softmax)
    acc = partial + matmul_f32(g.reshape(B, N, -1), wi)
    return cast(dt, acc + bias)


def tail_kernel(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi,
                bias, k: int, softmax: bool, keep_g: bool = False):
    """Launch ``csrc/bilateral_tail.cu`` (CUDA tensors, checked by
    :func:`tail`): the gate, then the merge on the tensor cores. The merge's
    operands go by 16-byte ``cp.async`` granules, so ``wi`` is padded with
    zeros to ``(ldg, ldw)``, both multiples of 4, and ``g`` has ``ldg``
    columns (the plain stage's pad columns are zero). ``keep_g`` also
    returns ``g``'s first ``k/2 * 4Fin`` columns."""
    B, N, two_f = partial.shape
    rows = B * N
    kd = inte_flat.shape[-1]                      # k/2 * 4Fin
    four_fin = kd // (k // 2)
    sfx = _lib.instance(inte_flat)
    # 16-byte granules: 4 fp32 or 8 bf16
    up = _lib.up8 if sfx else _lib.up4
    ldg, ldw = up(kd), up(two_f)
    _lib.check_rows(rows, 128, "bilateral_tail")
    if (ldg, ldw) != tuple(wi.shape):
        wi = torch.nn.functional.pad(wi, (0, ldw - two_f, 0, ldg - kd))
    wi = _lib.aligned(wi.contiguous())
    inte_flat = _lib.aligned(inte_flat)
    h_flat = None if h_flat is None else _lib.aligned(h_flat)
    g = torch.empty(rows, ldg, device=partial.device, dtype=inte_flat.dtype)
    y = torch.empty(B, N, two_f, device=partial.device, dtype=inte_flat.dtype)
    p = _lib.ptr
    _lib.check(getattr(_lib.library(), "pdgn_bilateral_tail" + sfx)(
        p(partial), p(inte_flat), p(h_flat), p(isc), p(ish), p(w2k), p(w2b),
        p(s2), p(t2), p(wi), ldw, p(bias), rows, k, four_fin, two_f, ldg,
        int(softmax), p(g), p(y), _lib.stream_handle(partial.device)),
        "pdgn_bilateral_tail" + sfx)
    _lib.LAUNCHES[("bilateral_tail_gated" if h_flat is not None
                   else "bilateral_tail_plain") + sfx] += 1
    return (y, g[:, :kd]) if keep_g else y


def tail_bwd_kernel(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi, dy,
                    k: int, softmax: bool, keep_g: bool = False):
    """Launch ``csrc/bilateral_tail_bwd.cu``. Returns the gradients of
    ``partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias`` (``None`` for
    ``h``..``t2`` on the plain stage); ``keep_g`` appends the gate ``g`` its
    gate pass wrote (``(rows, k/2 * 4Fin)``, the forward's bit for bit).

    Every product runs on the tensor cores by 16-byte ``cp.async``
    granules: ``dy`` and ``wi^T`` are zero-padded to ``t4`` rows or
    columns, ``wi^T`` and ``g`` to ``ldg`` columns, ``dv`` has ``ldv``
    columns (the kernel zeroes the pad) and ``w2k^T`` zero rows past 2Fin,
    all multiples of 4; the padded rows of ``d_wi`` are cut here. bf16
    ``inte`` launches the bf16 instance (:func:`tail_bwd_kernel_bf16`)."""
    if inte_flat.dtype == torch.bfloat16:
        return tail_bwd_kernel_bf16(inte_flat, h_flat, isc, ish, w2k, w2b, s2,
                                    t2, wi, dy, k, softmax, keep_g)
    _lib.instance(inte_flat)
    rows = dy.shape[0] * dy.shape[1]
    two_f = dy.shape[-1]
    hk = k // 2
    four_fin = inte_flat.shape[-1] // hk
    two_fin = four_fin // 2
    K = hk * four_fin
    ldg, t4, ldv = _lib.up4(K), _lib.up4(two_f), _lib.up4(two_fin)
    dev = dy.device
    f32 = dict(device=dev, dtype=torch.float32)
    gated = h_flat is not None
    pad = torch.nn.functional.pad
    _lib.check_rows(rows * (k if gated else 1), 128, "bilateral_tail_bwd")
    inte_flat = _lib.aligned(inte_flat)
    h_flat = None if h_flat is None else _lib.aligned(h_flat)
    dy_p = dy.reshape(rows, two_f)
    if t4 != two_f:
        dy_p = pad(dy_p, (0, t4 - two_f))
    dy_p = _lib.aligned(dy_p.contiguous())
    wi_t = _lib.aligned(pad(wi.T, (0, ldg - K, 0, t4 - two_f)).contiguous())
    d_inte = torch.empty_like(inte_flat)
    d_wi = torch.empty(ldg, two_f, **f32)
    d_bias = torch.empty(two_f, **f32)
    g = torch.empty(rows, ldg, **f32)
    dg = torch.empty(rows, ldg, **f32)
    colsum = torch.empty(-(-rows // 256), two_f, **f32)
    split = _lib.TN_SPLIT_ROWS
    tn = -(-rows // split) * ldg * two_f
    if gated:
        w2k_t = _lib.aligned(pad(w2k.T, (0, 0, 0, ldv - two_fin)).contiguous())
        # the tensor cores' error bound on v*s2 + t2 (v = h@w2k + w2b in
        # 3xTF32): within it of 0 the kernel takes the slot logit's
        # LeakyReLU branch by the sign of v*s2 + t2 recomputed in double
        kink = (s2.abs() * (w2k.abs().sum(0) * h_flat.abs().amax()
                            + w2b.abs()) * KINK_BOUND).contiguous()
        d_h = torch.empty_like(h_flat)
        d_w2k = torch.empty_like(w2k)
        dv = torch.empty(rows * k, ldv, **f32)
        tn = max(tn, -(-rows * k // split) * 64 * two_fin)
        sums = torch.empty(7 * two_fin, **f32)
        blocks = min(-(-rows // 16), _lib.MAX_GRID_Y)
        sum_scratch = torch.empty(blocks, 7 * two_fin, **f32)
    else:
        w2k_t = kink = d_h = d_w2k = dv = None
        sums = torch.empty(2 * four_fin, **f32)
        sum_scratch = torch.empty(-(-rows * hk // 64), 2 * four_fin, **f32)
    tn_scratch = torch.empty(tn, **f32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_bilateral_tail_bwd(
        p(inte_flat), p(h_flat), p(isc), p(ish), p(w2k), p(w2k_t), p(w2b),
        p(s2), p(t2), p(kink), p(wi_t), p(dy_p), rows, k, two_fin, two_f,
        ldg, t4, ldv, int(softmax), p(d_inte), p(d_h), p(d_w2k), p(d_wi),
        p(d_bias), p(sums), p(g), p(dg), p(dv), p(tn_scratch),
        p(sum_scratch), p(colsum), _lib.stream_handle(dev)),
        "pdgn_bilateral_tail_bwd")
    _lib.LAUNCHES["bilateral_tail_gated_bwd" if gated
                  else "bilateral_tail_plain_bwd"] += 1
    d_wi = d_wi[:K]
    d_isc, d_ish = sums[:four_fin], sums[four_fin:2 * four_fin]
    if not gated:
        out = (dy, d_inte, None, d_isc, d_ish, None, None, None, None, d_wi,
               d_bias)
    else:
        d_s2, d_t2, d_w2b = sums[2 * four_fin:].reshape(3, two_fin)
        out = (dy, d_inte, d_h, d_isc, d_ish, d_w2k, d_w2b, d_s2, d_t2, d_wi,
               d_bias)
    return out + (g[:, :K],) if keep_g else out


def tail_bwd_kernel_bf16(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi,
                         dy, k: int, softmax: bool, keep_g: bool = False,
                         keep_dv: bool = False):
    """Launch ``pdgn_bilateral_tail_bwd_bf16``: bf16 ``inte``, ``h`` and
    ``dy`` (the bf16 tail's cotangent); ``w2k`` and ``wi`` (fp32 or bf16)
    rounded to bf16 here. Same returns as :func:`tail_bwd_kernel`:
    ``d_partial`` the fp32 upcast of ``dy``, ``d_inte`` and ``d_h`` in bf16,
    the rest fp32; ``keep_g`` appends the bf16 ``g`` of the d_wi product
    and ``keep_dv`` (gated) the bf16 ``dv (B*N, k, 2Fin)`` of the d_h and
    d_w2k products. Operands padded to 8 bf16 (16 bytes)."""
    bf = torch.bfloat16
    if dy.dtype != bf:
        raise TypeError(f"tail bwd bf16: dy must be bfloat16, got {dy.dtype}")
    rows = dy.shape[0] * dy.shape[1]
    two_f = dy.shape[-1]
    hk = k // 2
    four_fin = inte_flat.shape[-1] // hk
    two_fin = four_fin // 2
    K = hk * four_fin
    ldg, t8, ldv = _lib.up8(K), _lib.up8(two_f), _lib.up8(two_fin)
    dev = dy.device
    f32 = dict(device=dev, dtype=torch.float32)
    gated = h_flat is not None
    pad = torch.nn.functional.pad
    _lib.check_rows(rows * (k if gated else 1), 128, "bilateral_tail_bwd")
    inte_flat = _lib.aligned(inte_flat)
    h_flat = None if h_flat is None else _lib.aligned(h_flat)
    dy_p = _lib.aligned(pad(dy.reshape(rows, two_f), (0, t8 - two_f))
                        .contiguous())
    wi_t = _lib.aligned(pad(wi.T.to(bf), (0, ldg - K, 0, t8 - two_f))
                        .contiguous())
    d_inte = torch.empty_like(inte_flat)
    d_wi = torch.empty(ldg, two_f, **f32)
    d_bias = torch.empty(two_f, **f32)
    g = torch.empty(rows, ldg, device=dev, dtype=bf)
    dg = torch.empty(rows, ldg, **f32)
    colsum = torch.empty(-(-rows // 256), two_f, **f32)
    split = _lib.TN_SPLIT_ROWS
    tn = -(-rows // split) * ldg * two_f
    if gated:
        w2k_b = w2k.to(bf).contiguous()
        w2k_t = _lib.aligned(pad(w2k_b.T, (0, 0, 0, ldv - two_fin))
                             .contiguous())
        d_h = torch.empty_like(h_flat)
        d_w2k = torch.empty(w2k.shape, **f32)
        dv = torch.empty(rows * k, ldv, device=dev, dtype=bf)
        tn = max(tn, -(-rows * k // split) * 64 * two_fin)
        sums = torch.empty(7 * two_fin, **f32)
        blocks = min(-(-rows // 16), _lib.MAX_GRID_Y)
        sum_scratch = torch.empty(blocks, 7 * two_fin, **f32)
    else:
        w2k_b = w2k_t = d_h = d_w2k = dv = None
        sums = torch.empty(2 * four_fin, **f32)
        sum_scratch = torch.empty(-(-rows * hk // 64), 2 * four_fin, **f32)
    tn_scratch = torch.empty(tn, **f32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_bilateral_tail_bwd_bf16(
        p(inte_flat), p(h_flat), p(isc), p(ish), p(w2k_b), p(w2k_t), p(w2b),
        p(s2), p(t2), p(wi_t), p(dy_p), rows, k, two_fin, two_f, ldg, t8,
        ldv, int(softmax), p(d_inte), p(d_h), p(d_w2k), p(d_wi), p(d_bias),
        p(sums), p(g), p(dg), p(dv), p(tn_scratch), p(sum_scratch),
        p(colsum), _lib.stream_handle(dev)), "pdgn_bilateral_tail_bwd_bf16")
    _lib.LAUNCHES["bilateral_tail_gated_bwd_bf16" if gated
                  else "bilateral_tail_plain_bwd_bf16"] += 1
    d_wi = d_wi[:K]
    d_isc, d_ish = sums[:four_fin], sums[four_fin:2 * four_fin]
    d_partial = dy.float()
    if not gated:
        out = (d_partial, d_inte, None, d_isc, d_ish, None, None, None, None,
               d_wi, d_bias)
    else:
        d_s2, d_t2, d_w2b = sums[2 * four_fin:].reshape(3, two_fin)
        out = (d_partial, d_inte, d_h, d_isc, d_ish, d_w2k, d_w2b, d_s2, d_t2,
               d_wi, d_bias)
    if keep_g:
        out += (g[:, :K],)
    if keep_dv and gated:
        out += (dv.reshape(rows, k, ldv)[..., :two_fin],)
    return out


def _lrelu_ge(x):
    """LeakyReLU and its slope as the TPU kernels take them (1 at 0)"""
    pos = x >= 0
    return torch.where(pos, x, 0.01 * x), torch.where(pos, 1.0, 0.01)


def tail_bwd_plain_bf16(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi,
                        dy, k: int, softmax: bool, keep_g: bool = False,
                        keep_dv: bool = False):
    """The bf16 backward's plain version, at the TPU kernels' rounding
    points (``_gated_bwd_kernel``, ``_plain_bwd_kernel``): ``dg = dy_b @
    wi_b^T`` in fp32; the gate recomputed from bf16 ``h`` and ``w2k`` with
    fp32 folds, LeakyReLUs (slope 1 at 0) and softmax (max, the sum of the
    exponentials, one reciprocal), its weight ``w`` unrounded; ``g = (gi *
    w)`` rounded once for ``d_wi = g^T dy_b`` (plain stage: ``gi``
    rounded); ``dpre`` of the slot logits rounded for ``d_h`` and
    ``d_w2k``; ``d_inte`` and ``d_h`` bf16, the rest fp32. Same inputs and
    returns as :func:`tail_bwd_kernel_bf16`, ``keep_g`` and ``keep_dv``
    included."""
    if dy.dtype != torch.bfloat16:
        raise TypeError(f"tail bwd bf16: dy must be bfloat16, got {dy.dtype}")
    B, N, two_f = dy.shape
    rows = B * N
    hk = k // 2
    four_fin = inte_flat.shape[-1] // hk
    two_fin = four_fin // 2
    dyf = dy.float().reshape(rows, two_f)
    d_bias = dyf.sum(dim=0)
    dg = (dyf @ round_bf16(wi.float()).T).reshape(rows, hk, four_fin)
    iw = inte_flat.float().reshape(rows, hk, four_fin)
    gi, mi = _lrelu_ge(iw * isc + ish)
    out_h = out_w2 = dpre_b = None
    if h_flat is not None:
        h = h_flat.float().reshape(rows, k, -1)
        pre = h @ round_bf16(w2k.float()) + w2b      # (rows, k, 2Fin)
        hat = pre * s2 + t2
        u, m2 = _lrelu_ge(hat)
        if softmax:
            e = torch.exp(u - u.amax(dim=1, keepdim=True))
            w = e * (1.0 / e.sum(dim=1, keepdim=True))
        else:
            w = u
        wblk = w.reshape(rows, hk, four_fin)
        g = (gi * wblk).to(torch.bfloat16)
        dpre_i = (dg * wblk) * mi
        dws = (dg * gi).reshape(rows, k, two_fin)
        dus = w * (dws - (dws * w).sum(dim=1, keepdim=True)) if softmax \
            else dws
        dhat = dus * m2
        dpre = dhat * s2
        dpre_b = round_bf16(dpre)
        d_h = (dpre_b @ round_bf16(w2k.float()).T).to(torch.bfloat16)
        d_w2k = torch.einsum("rsh,rsc->hc", h, dpre_b)
        out_h = d_h.reshape(h_flat.shape)
        out_w2 = (d_w2k, dpre.sum(dim=(0, 1)), (dhat * pre).sum(dim=(0, 1)),
                  dhat.sum(dim=(0, 1)))
    else:
        g = gi.to(torch.bfloat16)
        dpre_i = dg * mi
    d_inte = (dpre_i * isc).to(torch.bfloat16).reshape(inte_flat.shape)
    d_isc = (dpre_i * iw).sum(dim=(0, 1))
    d_ish = dpre_i.sum(dim=(0, 1))
    g = g.reshape(rows, hk * four_fin)
    d_wi = g.float().T @ dyf
    if out_w2 is None:
        out = (dyf.reshape(B, N, two_f), d_inte, None, d_isc, d_ish, None,
               None, None, None, d_wi, d_bias)
    else:
        d_w2k, d_w2b, d_s2, d_t2 = out_w2
        out = (dyf.reshape(B, N, two_f), d_inte, out_h, d_isc, d_ish, d_w2k,
               d_w2b, d_s2, d_t2, d_wi, d_bias)
    if keep_g:
        out += (g,)
    if keep_dv and dpre_b is not None:
        out += (dpre_b.to(torch.bfloat16),)
    return out


def tail_bwd_plain(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2,
                   wi, bias, dy, k: int, softmax: bool):
    """The plain backward: autograd's VJP of :func:`tail_reference`; same
    returns as :func:`tail_bwd_kernel`."""
    ins = [partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi, bias]
    live = [i for i, t in enumerate(ins) if t is not None]
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in ins]
        y = tail_reference(*ins, k, softmax)
        grads = torch.autograd.grad(y, [ins[i] for i in live], dy)
    out = [None] * len(ins)
    for i, g in zip(live, grads):
        out[i] = g
    return tuple(out)


class _Tail(torch.autograd.Function):

    @staticmethod
    def forward(ctx, k, softmax, partial, inte_flat, h_flat, isc, ish, w2k,
                w2b, s2, t2, wi, bias):
        # fp32 weights of a bf16 tail are rounded here (as _pallas_tail casts
        # them), so that autograd hands their gradients back in fp32
        dt = inte_flat.dtype
        args = (partial, inte_flat, h_flat, isc, ish,
                None if w2k is None else w2k.to(dt), w2b, s2, t2, wi.to(dt),
                bias, k, softmax)
        ctx.k, ctx.softmax = k, softmax
        ctx.save_for_backward(partial, inte_flat, h_flat, isc, ish, w2k, w2b,
                              s2, t2, wi, bias)
        if partial.device.type == "cuda":
            return tail_kernel(*args)
        return tail_reference(*args)

    @staticmethod
    def backward(ctx, dy):
        (partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi,
         bias) = ctx.saved_tensors
        if dy.device.type == "cuda":
            g = tail_bwd_kernel(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2,
                                wi, dy, ctx.k, ctx.softmax)
        elif inte_flat.dtype == torch.bfloat16:
            g = tail_bwd_plain_bf16(inte_flat, h_flat, isc, ish, w2k, w2b, s2,
                                    t2, wi, dy, ctx.k, ctx.softmax)
        else:
            g = tail_bwd_plain(partial, inte_flat, h_flat, isc, ish, w2k, w2b,
                               s2, t2, wi, bias, dy, ctx.k, ctx.softmax)
        return (None, None) + tuple(g)


def tail(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi, bias,
         k: int, softmax: bool = True):
    """The tail on prepared operands, differentiable; ``h_flat=None`` is
    the plain stage (``w2k``..``t2`` are then ignored and may be ``None``).
    CUDA tensors launch the kernels, CPU tensors run the plain versions.
    ``inte`` float32 or bfloat16: ``h`` in its dtype, the rest float32 (a
    bf16 tail rounds ``w2k`` and ``wi`` inside and returns their gradients
    in float32). CPU operands may also be float64 (an arbiter's dtype)."""
    B, N, two_f = partial.shape
    hk = k // 2
    four_fin = inte_flat.shape[-1] // max(hk, 1)
    two_fin = four_fin // 2
    dt, wdt = inte_flat.dtype, torch.float32
    if dt == torch.float64 and partial.device.type == "cpu":
        wdt = dt
    elif dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inte: expected float32 or bfloat16, got {dt}")
    checks = [("partial", partial, (B, N, two_f), wdt),
              ("inte", inte_flat, (B, N, hk * four_fin), dt),
              ("isc", isc, (four_fin,), wdt), ("ish", ish, (four_fin,), wdt),
              ("wi", wi, (hk * four_fin, two_f), wdt),
              ("bias", bias, (two_f,), wdt)]
    if h_flat is not None:
        hidden = h_flat.shape[-1] // k
        checks += [("h", h_flat, (B, N, k * hidden), dt),
                   ("w2k", w2k, (hidden, two_fin), wdt),
                   ("w2b", w2b, (two_fin,), wdt),
                   ("s2", s2, (two_fin,), wdt), ("t2", t2, (two_fin,), wdt)]
    for name, t, shape, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != partial.device:
            raise ValueError(f"{name} is on {t.device}, partial on "
                             f"{partial.device}")
    if k % 2:
        raise ValueError(f"tail: k must be even, got {k}")
    if partial.device.type == "cuda":
        if h_flat is not None and (h_flat.shape[-1] != k * 64 or k > MAX_K):
            raise ValueError(f"tail kernel: needs hidden width 64 and k <= "
                             f"MAX_K={MAX_K}, got k={k}")
    elif partial.device.type != "cpu":
        raise ValueError(f"tail: unsupported device {partial.device}")
    if h_flat is None:
        w2k = w2b = s2 = t2 = None
    return _Tail.apply(k, softmax, partial, inte_flat, h_flat, isc, ish, w2k,
                       w2b, s2, t2, wi, bias)


def edge_conv_tail(partial, inte_raw, h: Optional[torch.Tensor], inte_stats,
                   w2_params, w2_stats, merge_kernel, merge_bias, k: int, *,
                   epsilon: float = 1e-5, softmax: bool = True):
    """The stage tail with the JAX entry's interface.

    ``inte_stats``/``w2_stats`` are ``(mean, var, scale, bias)`` in block
    channel order; ``merge_kernel (2k*2Fin, 2F)`` is the reference slot
    layout. Returns ``y (B, N, 2F)`` in ``inte_raw``'s dtype (a bf16
    ``inte`` takes the merge weight and conv_all2's kernel in bf16, cast
    inside :func:`tail` as the JAX entry casts them inside its kernel's
    function, so that their gradients stay fp32).
    """
    B, N, _ = partial.shape
    hk = k // 2
    four_fin = inte_raw.shape[-1] // hk
    two_fin = four_fin // 2
    two_f = merge_kernel.shape[-1]
    kr = merge_kernel.reshape(2 * k, two_fin, two_f)
    # inte half -> block conv layout: wi_blk[wp, j*2Fin+c] = wi[j*hk+wp, c]
    wi = kr[k:].reshape(2, hk, two_fin, two_f).transpose(0, 1)
    wi = wi.reshape(hk * four_fin, two_f).contiguous()

    i_mean, i_var, i_scale, i_bias = inte_stats
    isc = i_scale * torch.rsqrt(i_var + epsilon)
    ish = i_bias - i_mean * isc
    w2k = w2b = s2 = t2 = None
    if h is not None:
        if h.dim() == 4:
            h = h.reshape(B, N, k * h.shape[-1])
        w2k, w2b = w2_params
        w2k, w2b = w2k.contiguous(), w2b.contiguous()
        m2, v2, sc2, b2 = w2_stats
        s2 = sc2 * torch.rsqrt(v2 + epsilon)
        t2 = b2 - m2 * s2
        h = h.contiguous()
    return tail(partial.contiguous(), inte_raw.contiguous(), h,
                isc.contiguous(), ish.contiguous(), w2k, w2b, s2, t2, wi,
                merge_bias.contiguous(), k, softmax)
