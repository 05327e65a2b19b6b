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
"""

from __future__ import annotations

from typing import Optional

import torch

from pdgn_tpu_torch.ops.kernels import _lib


def _leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def tail_reference(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2,
                   wi, bias, k: int, softmax: bool):
    """Port of ``_reference``: the tail on lane-flat operands."""
    B, N, _ = partial.shape
    hk = k // 2
    four_fin = inte_flat.shape[-1] // hk
    gi = _leaky(inte_flat.reshape(B, N, hk, four_fin) * isc + ish)
    if h_flat is not None:
        hidden = h_flat.shape[-1] // k
        h = h_flat.reshape(B, N, k, hidden)
        u = _leaky((torch.matmul(h, w2k) + w2b) * s2 + t2)
        if softmax:
            u = torch.softmax(u, dim=2)
        # slot pairs (2wp, 2wp+1) -> block channels (contiguous reshape)
        gi = gi * u.reshape(B, N, hk, four_fin)
    acc = partial + torch.matmul(gi.reshape(B, N, hk * four_fin), wi)
    return acc + bias


def tail_kernel(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi,
                bias, k: int, softmax: bool):
    """Launch ``csrc/bilateral_tail.cu`` (CUDA tensors, checked by
    :func:`tail`)."""
    B, N, two_f = partial.shape
    four_fin = inte_flat.shape[-1] // (k // 2)
    _lib.check_rows(B * N, 32, "bilateral_tail")
    g = torch.empty_like(inte_flat)
    y = torch.empty_like(partial)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_bilateral_tail(
        p(partial), p(inte_flat), p(h_flat), p(isc), p(ish), p(w2k), p(w2b),
        p(s2), p(t2), p(wi), p(bias), B * N, k, four_fin // 2, two_f,
        int(softmax), p(g), p(y), _lib.stream_handle(partial.device)),
        "pdgn_bilateral_tail")
    _lib.LAUNCHES["bilateral_tail_gated" if h_flat is not None
                  else "bilateral_tail_plain"] += 1
    return y


def tail_bwd_kernel(inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi, dy,
                    k: int, softmax: bool):
    """Launch ``csrc/bilateral_tail_bwd.cu``. Returns the gradients of
    ``partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias`` (``None`` for
    ``h``..``t2`` on the plain stage)."""
    rows = dy.shape[0] * dy.shape[1]
    two_f = dy.shape[-1]
    hk = k // 2
    four_fin = inte_flat.shape[-1] // hk
    two_fin = four_fin // 2
    K = hk * four_fin
    dev = dy.device
    f32 = dict(device=dev, dtype=torch.float32)
    gated = h_flat is not None
    _lib.check_rows(rows, 32, "bilateral_tail_bwd")
    dy = dy.contiguous()
    wi_t = wi.T.contiguous()
    d_inte = torch.empty_like(inte_flat)
    d_wi = torch.empty(K, two_f, **f32)
    d_bias = torch.empty(two_f, **f32)
    g = torch.empty_like(inte_flat)
    colsum = torch.empty(-(-rows // 256), two_f, **f32)
    split = _lib.TN_SPLIT_ROWS
    tn = -(-rows // split) * K * two_f
    if gated:
        w2k_t = w2k.T.contiguous()
        d_h = torch.empty_like(h_flat)
        d_w2k = torch.empty_like(w2k)
        dv = torch.empty(rows * k, two_fin, **f32)
        tn = max(tn, -(-rows * k // split) * 64 * two_fin)
        sums = torch.empty(7 * two_fin, **f32)
        sum_scratch = torch.empty(-(-rows // 32), 7 * two_fin, **f32)
    else:
        w2k_t = d_h = d_w2k = dv = None
        sums = torch.empty(2 * four_fin, **f32)
        sum_scratch = torch.empty(-(-rows * hk // 64), 2 * four_fin, **f32)
    tn_scratch = torch.empty(tn, **f32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_bilateral_tail_bwd(
        p(inte_flat), p(h_flat), p(isc), p(ish), p(w2k), p(w2k_t), p(w2b),
        p(s2), p(t2), p(wi_t), p(dy), rows, k, two_fin, two_f, int(softmax),
        p(d_inte), p(d_h), p(d_w2k), p(d_wi), p(d_bias), p(sums), p(g),
        p(dv), p(tn_scratch), p(sum_scratch), p(colsum),
        _lib.stream_handle(dev)), "pdgn_bilateral_tail_bwd")
    _lib.LAUNCHES["bilateral_tail_gated_bwd" if gated
                  else "bilateral_tail_plain_bwd"] += 1
    d_isc, d_ish = sums[:four_fin], sums[four_fin:2 * four_fin]
    if not gated:
        return (dy, d_inte, None, d_isc, d_ish, None, None, None, None, d_wi,
                d_bias)
    d_s2, d_t2, d_w2b = sums[2 * four_fin:].reshape(3, two_fin)
    return (dy, d_inte, d_h, d_isc, d_ish, d_w2k, d_w2b, d_s2, d_t2, d_wi,
            d_bias)


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
        args = (partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi,
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
        else:
            g = tail_bwd_plain(partial, inte_flat, h_flat, isc, ish, w2k, w2b,
                               s2, t2, wi, bias, dy, ctx.k, ctx.softmax)
        return (None, None) + tuple(g)


def tail(partial, inte_flat, h_flat, isc, ish, w2k, w2b, s2, t2, wi, bias,
         k: int, softmax: bool = True):
    """The tail on prepared operands, differentiable; ``h_flat=None`` is
    the plain stage (``w2k``..``t2`` are then ignored and may be ``None``).
    CUDA tensors launch the kernels, CPU tensors run the plain versions."""
    B, N, two_f = partial.shape
    hk = k // 2
    four_fin = inte_flat.shape[-1] // max(hk, 1)
    two_fin = four_fin // 2
    checks = [("partial", partial, (B, N, two_f)),
              ("inte", inte_flat, (B, N, hk * four_fin)),
              ("isc", isc, (four_fin,)), ("ish", ish, (four_fin,)),
              ("wi", wi, (hk * four_fin, two_f)), ("bias", bias, (two_f,))]
    if h_flat is not None:
        hidden = h_flat.shape[-1] // k
        checks += [("h", h_flat, (B, N, k * hidden)),
                   ("w2k", w2k, (hidden, two_fin)), ("w2b", w2b, (two_fin,)),
                   ("s2", s2, (two_fin,)), ("t2", t2, (two_fin,))]
    for name, t, shape in checks:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
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
        if h_flat is not None and (h_flat.shape[-1] != k * 64 or k > 16):
            raise ValueError("tail kernel: needs hidden width 64 and k <= 16")
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
    layout. Returns ``y (B, N, 2F)``.
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
        w2k, w2b = (t.contiguous() for t in w2_params)
        m2, v2, sc2, b2 = w2_stats
        s2 = sc2 * torch.rsqrt(v2 + epsilon)
        t2 = b2 - m2 * s2
        h = h.contiguous()
    return tail(partial.contiguous(), inte_raw.contiguous(), h,
                isc.contiguous(), ish.contiguous(), w2k, w2b, s2, t2, wi,
                merge_bias.contiguous(), k, softmax)
