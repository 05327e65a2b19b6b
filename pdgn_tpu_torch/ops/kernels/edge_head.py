"""Edge-conv stage head: kNN + gathers + window conv + merge partial
(port of pdgn_tpu/ops/pallas/edge_head.py), forward and backward.

:func:`edge_conv_head` keeps the JAX entry's signature and layouts
(``conv_kernel (1, W, 2Cf, 4Fin)`` in block channel order, ``merge_kernel
(2k*2Cf, 2F)`` slot-major), prepares the parameter-side operands as the JAX
entry does (differentiable plain torch), and hands them to :func:`edge_head`,
a ``torch.autograd.Function``. For CUDA tensors its forward launches
``csrc/edge_head.cu`` and its backward ``csrc/edge_head_bwd.cu``; for CPU
tensors they run the plain PyTorch versions (:func:`head_plain`: exact kNN +
:func:`head_reference_given_idx`; :func:`head_bwd_plain`: autograd's VJP of
that body for the same graph).
"""

from __future__ import annotations

from typing import Optional

import torch

from pdgn_tpu_torch.ops.edges import neighbor_idx
from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels import _lib

PROJ = 32          # weight-net projection channels (16 fea + 16 xyz)
_SUPPORTED_K = (2, 4, 6, 8, 10, 12, 16)


def head_reference_given_idx(x, wn_flat, conv_a, pb_point, a_merge, wen,
                             pb_merge, pcat, ppoint, idx, k: int,
                             window: int):
    """Gathers + window conv + merge partial + sums for a fixed graph
    (port of ``_head_reference_given_idx``).

    Returns ``inte (B, N, hk*4Fin)``, ``partial (B, N, 2F)``,
    ``stats (2, 4Fin)`` and, gated, ``wfea``/``wxyz (B, N, k*16)`` and
    ``wstats (2, k*32)`` (else ``None``s).
    """
    B, N, C = x.shape
    hk = k // 2
    four_fin = conv_a.shape[-1]

    nbr = grouping(x, idx)                                # (B, N, k, C)
    nbr_flat = nbr.reshape(B, N, k * C)
    partial = (torch.matmul(x, a_merge) + torch.matmul(nbr_flat, wen)
               + pb_merge[:, None, :])

    point = torch.matmul(x, conv_a) + pb_point[:, None, :]
    wnr = wn_flat.reshape(window, C, four_fin)
    parts = []
    for wp in range(hk):
        y = point
        for t in range(window):
            y = y + torch.matmul(nbr[:, :, wp + t, :], wnr[t])
        parts.append(y)
    inte = torch.cat(parts, dim=-1)                       # (B, N, hk*4Fin)
    inte4 = inte.reshape(B, N, hk, four_fin)
    stats = torch.stack([inte4.sum(dim=(0, 1, 2)),
                         (inte4 * inte4).sum(dim=(0, 1, 2))])
    if pcat is None:
        return inte, partial, stats, None, None, None

    # weight-net front in the (window, j) slot order
    idx_b = idx.reshape(B, N, 2, hk).transpose(2, 3).reshape(B, N, k)
    half = PROJ // 2
    wrow = grouping(pcat, idx_b) + ppoint[:, :, None, :]  # (B, N, k, 32)
    wfea = wrow[..., :half].reshape(B, N, k * half)
    wxyz = wrow[..., half:].reshape(B, N, k * half)
    wstats = torch.stack([wrow.sum(dim=(0, 1)).reshape(k * PROJ),
                          (wrow * wrow).sum(dim=(0, 1)).reshape(k * PROJ)])
    return inte, partial, stats, wfea, wxyz, wstats


def head_plain(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
               pcat, ppoint, k: int, window: int):
    """Plain PyTorch head: exact kNN on ``x_knn`` + the fixed-graph body."""
    idx = neighbor_idx(x_knn, k)
    return (idx,) + head_reference_given_idx(
        x, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, pcat, ppoint,
        idx, k, window)


def head_kernel(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
                pcat, ppoint, k: int, window: int):
    """Launch ``csrc/edge_head.cu`` (CUDA tensors, checked by
    :func:`edge_head`)."""
    B, N, C = x.shape
    cf = x_knn.shape[-1]
    hk = k // 2
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    rows = B * N
    _lib.check_rows(rows * hk, 64, "edge_head")
    w_conv = torch.cat([wn_flat, conv_a], dim=0).contiguous()
    w_merge = torch.cat([wen, a_merge], dim=0).contiguous()
    sq = torch.empty(rows, **f32)
    idx = torch.empty(B, N, k, device=dev, dtype=torch.int32)
    inte = torch.empty(B, N, hk * four_fin, **f32)
    partial = torch.empty(B, N, two_f, **f32)
    stats = torch.empty(2, four_fin, **f32)
    conv_scratch = torch.empty(-(-rows * hk // 64), 2, four_fin, **f32)
    gated = pcat is not None
    if gated:
        wfea = torch.empty(B, N, k * PROJ // 2, **f32)
        wxyz = torch.empty(B, N, k * PROJ // 2, **f32)
        wstats = torch.empty(2, k * PROJ, **f32)
        w_scratch = torch.empty(-(-rows // 64), 2, k * PROJ, **f32)
    else:
        wfea = wxyz = wstats = w_scratch = None
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_edge_head(
        p(x), p(x_knn), p(sq), B, N, C, cf, k, p(w_conv), p(pb_point),
        four_fin, p(w_merge), p(pb_merge), two_f, p(pcat), p(ppoint),
        p(idx), p(inte), p(partial), p(stats), p(conv_scratch), p(wfea),
        p(wxyz), p(wstats), p(w_scratch), _lib.stream_handle(dev)),
        "pdgn_edge_head")
    _lib.LAUNCHES["edge_head"] += 1
    return idx, inte, partial, stats, wfea, wxyz, wstats


def head_bwd_kernel(x, idx, inte, wn_flat, conv_a, a_merge, wen, pcat,
                    ppoint, cts, k: int):
    """Launch ``csrc/edge_head_bwd.cu``. ``cts`` are the cotangents of
    ``inte, partial, stats`` and, gated, ``wfea, wxyz, wstats``. Returns
    the gradients of ``x, wn_flat, conv_a, pb_point, a_merge, wen,
    pb_merge, pcat, ppoint`` (the last two ``None`` for the plain stage)."""
    B, N, C = x.shape
    hk = k // 2
    window = hk + 1
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    rows = B * N
    _lib.check_rows(rows * hk, 64, "edge_head_bwd")
    w_conv_t = torch.cat([wn_flat, conv_a], dim=0).T.contiguous()
    w_merge_t = torch.cat([wen, a_merge], dim=0).T.contiguous()
    gated = pcat is not None
    d_inte, d_partial, d_stats = (c.contiguous() for c in cts[:3])
    d_wfea = d_wxyz = d_wstats = None
    if gated:
        d_wfea, d_wxyz, d_wstats = (c.contiguous() for c in cts[3:6])
    wc, mc = (window + 1) * C, (k + 1) * C
    d_x = torch.empty(B, N, C, **f32)
    d_wconv = torch.empty(wc, four_fin, **f32)
    d_wmerge = torch.empty(mc, two_f, **f32)
    d_pb_point = torch.empty(B, four_fin, **f32)
    d_pb_merge = torch.empty(B, two_f, **f32)
    d_pcat = torch.empty(B, N, PROJ, **f32) if gated else None
    d_ppoint = torch.empty(B, N, PROJ, **f32) if gated else None
    dp = torch.empty(rows * hk, wc, **f32)
    dm = torch.empty(rows, mc, **f32)
    splits = max(-(-rows * hk // _lib.TN_SPLIT_ROWS) * wc * four_fin,
                 -(-rows // _lib.TN_SPLIT_ROWS) * mc * two_f)
    tn_scratch = torch.empty(splits, **f32)
    count = torch.empty(rows, **i32)
    cursor = torch.empty(rows, **i32)
    offsets = torch.empty(rows + 1, **i32)
    entries = torch.empty(rows * k, **i32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_edge_head_bwd(
        p(x), p(idx), p(inte), B, N, C, k, four_fin, two_f, p(w_conv_t),
        p(w_merge_t), p(d_inte), p(d_partial), p(d_stats), p(pcat),
        p(ppoint), p(d_wfea), p(d_wxyz), p(d_wstats), p(d_x), p(d_wconv),
        p(d_wmerge), p(d_pb_point), p(d_pb_merge), p(d_pcat), p(d_ppoint),
        p(dp), p(dm), p(tn_scratch), p(count), p(cursor), p(offsets),
        p(entries), _lib.stream_handle(dev)), "pdgn_edge_head_bwd")
    _lib.LAUNCHES["edge_head_bwd"] += 1
    return (d_x, d_wconv[:window * C], d_wconv[window * C:], d_pb_point,
            d_wmerge[k * C:], d_wmerge[:k * C], d_pb_merge, d_pcat, d_ppoint)


def head_bwd_plain(x, idx, wn_flat, conv_a, pb_point, a_merge, wen,
                   pb_merge, pcat, ppoint, cts, k: int, window: int):
    """The plain backward: autograd's VJP of :func:`head_reference_given_idx`
    for the graph ``idx``, same inputs and returns as
    :func:`head_bwd_kernel`."""
    gated = pcat is not None
    ins = [x, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge]
    if gated:
        ins += [pcat, ppoint]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in ins]
        outs = head_reference_given_idx(
            *ins[:7], ins[7] if gated else None, ins[8] if gated else None,
            idx, k, window)
        outs = [o for o in outs if o is not None]
        grads = torch.autograd.grad(outs, ins, cts[:len(outs)],
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, ins)]
    return tuple(grads) + ((None, None) if not gated else ())


class _Head(torch.autograd.Function):
    """The head with a backward that holds the graph constant; ``idx`` is
    not differentiable, the BN sums (``stats``, ``wstats``) are."""

    @staticmethod
    def forward(ctx, k, window, x, x_knn, wn_flat, conv_a, pb_point, a_merge,
                wen, pb_merge, pcat, ppoint):
        args = (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
                pcat, ppoint, k, window)
        if x.device.type == "cuda":
            out = head_kernel(*args)
        else:
            out = head_plain(*args)
        idx, inte = out[0], out[1]
        ctx.k, ctx.window = k, window
        ctx.save_for_backward(x, idx, inte, wn_flat, conv_a, pb_point,
                              a_merge, wen, pb_merge, pcat, ppoint)
        ctx.mark_non_differentiable(idx)
        return tuple(o for o in out if o is not None)

    @staticmethod
    def backward(ctx, *grads):
        (x, idx, inte, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
         pcat, ppoint) = ctx.saved_tensors
        cts = grads[1:]                                   # idx has none
        if x.device.type == "cuda":
            g = head_bwd_kernel(x, idx, inte, wn_flat, conv_a, a_merge, wen,
                                pcat, ppoint, cts, ctx.k)
        else:
            g = head_bwd_plain(x, idx, wn_flat, conv_a, pb_point, a_merge,
                               wen, pb_merge, pcat, ppoint, cts, ctx.k,
                               ctx.window)
        d_x, d_wn, d_ca, d_pb, d_am, d_wen, d_pbm, d_pcat, d_pp = g
        return (None, None, d_x, None, d_wn, d_ca, d_pb, d_am, d_wen, d_pbm,
                d_pcat, d_pp)


def _check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def edge_head(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
              pcat, ppoint, k: int, window: int):
    """The head on prepared operands, differentiable (the graph held
    constant). CUDA tensors launch the kernels, CPU tensors run the plain
    versions; anything else raises.

    Returns ``idx, inte, partial, stats, wfea, wxyz, wstats`` (the last
    three ``None`` for the plain stage).
    """
    B, N, C = x.shape
    cf = x_knn.shape[-1]
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    checks = [("x", x, (B, N, C)), ("x_knn", x_knn, (B, N, cf)),
              ("wn_flat", wn_flat, (window * C, four_fin)),
              ("conv_a", conv_a, (C, four_fin)),
              ("pb_point", pb_point, (B, four_fin)),
              ("a_merge", a_merge, (C, two_f)),
              ("wen", wen, (k * C, two_f)),
              ("pb_merge", pb_merge, (B, two_f))]
    if pcat is not None:
        checks += [("pcat", pcat, (B, N, PROJ)),
                   ("ppoint", ppoint, (B, N, PROJ))]
    for name, t, shape in checks:
        _check(name, t, shape)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if k % 2 or window != k // 2 + 1 or N <= k:
        raise ValueError(f"edge_head: need even k, window k/2+1 and N > k "
                         f"(k={k}, window={window}, N={N})")
    if x.device.type == "cuda":
        if k not in _SUPPORTED_K:
            raise ValueError(f"edge_head kernel: k={k} not in {_SUPPORTED_K}")
    elif x.device.type != "cpu":
        raise ValueError(f"edge_head: unsupported device {x.device}")
    out = _Head.apply(k, window, x, x_knn, wn_flat, conv_a, pb_point,
                      a_merge, wen, pb_merge, pcat, ppoint)
    return tuple(out) + ((None, None, None) if pcat is None else ())


def head_operands(x, conv_kernel, conv_bias, merge_kernel, k: int,
                  xs: Optional[torch.Tensor] = None):
    """Parameter-side preparation of the JAX entry (edge_head.py:708-743):
    ``x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, window``.

    With ``xs`` every contraction of the per-batch half collapses to a
    per-batch bias; the graph is still built from the full concat
    ``[xs broadcast | x]``, as the JAX package's exact path does.
    """
    B, N, C = x.shape
    window = conv_kernel.shape[1]
    four_fin = conv_kernel.shape[-1]
    two_f = merge_kernel.shape[-1]
    cx = 0 if xs is None else xs.shape[-1]
    cf = cx + C

    wc = conv_kernel[0, :, :cf, :]
    wn = conv_kernel[0, :, cf:, :]
    conv_a_full = torch.sum(wc - wn, dim=0)               # (Cf, 4Fin)
    kr = merge_kernel.reshape(2 * k, 2 * cf, two_f)
    a_merge_full = torch.sum(kr[:k, :cf, :] - kr[:k, cf:, :], dim=0)
    wen_full = kr[:k, cf:, :]                             # (k, Cf, 2F)

    if xs is None:
        x_knn = x
        conv_a = conv_a_full
        wn_flat = wn.reshape(window * cf, four_fin)
        a_merge = a_merge_full
        wen = wen_full.reshape(k * cf, two_f)
        pb_point = conv_bias[None, :].expand(B, four_fin)
        pb_merge = x.new_zeros(B, two_f)
    else:
        x_knn = torch.cat([xs[:, None, :].expand(B, N, cx), x], dim=-1)
        conv_a = conv_a_full[cx:]
        wn_flat = wn[:, cx:, :].reshape(window * C, four_fin)
        m_point = conv_a_full[:cx] + torch.sum(wn[:, :cx, :], dim=0)
        pb_point = torch.matmul(xs, m_point) + conv_bias
        a_merge = a_merge_full[cx:]
        wen = wen_full[:, cx:, :].reshape(k * C, two_f)
        m_merge = a_merge_full[:cx] + torch.sum(wen_full[:, :cx, :], dim=0)
        pb_merge = torch.matmul(xs, m_merge)
    c = torch.Tensor.contiguous
    return (c(x_knn), c(wn_flat), c(conv_a), c(pb_point), c(a_merge), c(wen),
            c(pb_merge), window)


def edge_conv_head(x, conv_kernel, conv_bias, merge_kernel, k: int,
                   pcat=None, ppoint=None, *, xs=None):
    """Fused stage head with the JAX entry's interface and returns:
    ``idx, inte, partial, (mean, var)`` and, gated, ``wfea, wxyz,
    fea_stats, xyz_stats`` (``None``s for the plain stage)."""
    B, N, C = x.shape
    hk = k // 2
    if k % 2 or conv_kernel.shape[1] != hk + 1:
        raise ValueError(f"edge_conv_head: k={k} must be even and the conv "
                         f"window k/2+1, got {conv_kernel.shape[1]}")
    (x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
     window) = head_operands(x, conv_kernel, conv_bias, merge_kernel, k, xs)
    idx, inte, partial, stats, wfea, wxyz, wstats = edge_head(
        x.contiguous(), x_knn, wn_flat, conv_a, pb_point, a_merge, wen,
        pb_merge, None if pcat is None else pcat.contiguous(),
        None if ppoint is None else ppoint.contiguous(), k, window)

    count = B * N * hk
    mean = stats[0] / count
    var = stats[1] / count - mean * mean
    if pcat is None:
        return idx, inte, partial, (mean, var), None, None, None, None
    wcount = B * N * k
    ws = wstats.reshape(2, k, PROJ)
    wm = ws[0].sum(dim=0) / wcount
    wv = ws[1].sum(dim=0) / wcount - wm * wm
    half = PROJ // 2
    return (idx, inte, partial, (mean, var), wfea, wxyz,
            (wm[:half], wv[:half]), (wm[half:], wv[half:]))
