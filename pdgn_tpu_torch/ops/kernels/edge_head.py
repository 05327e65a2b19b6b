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

from pdgn_tpu_torch.ops.grouping import grouping
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.knn import knn_exclude_first
from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

PROJ = 32          # weight-net projection channels (16 fea + 16 xyz)
# the kernel's graph is knn_select's (csrc/knn.cu) for k+1 rows: k + 1 <=
# its longest list, the JAX knn_topk kernel's limit too
MAX_K = 126


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
    """Plain PyTorch head: exact kNN on ``x_knn`` (norm expansion, row
    minimum dropped) + the fixed-graph body."""
    idx = knn_exclude_first(self_pairwise_sqdist(x_knn), k)
    return (idx,) + head_reference_given_idx(
        x, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, pcat, ppoint,
        idx, k, window)


def pack_head_weights(wn_flat, conv_a, a_merge, wen, k: int, window: int):
    """``W_all = [Wn_0 | .. | Wn_{window-1} | conv_a | We_0 | .. | We_{k-1}
    | A]``, shape ``(C, (window+1)*4Fin + (k+1)*2F)``: one product
    ``x @ W_all`` gives every term the head gathers, since ``x[idx] @ W =
    (x @ W)[idx]``."""
    C, four_fin = conv_a.shape
    two_f = a_merge.shape[-1]
    wn = wn_flat.reshape(window, C, four_fin).permute(1, 0, 2)
    we = wen.reshape(k, C, two_f).permute(1, 0, 2)
    return torch.cat([wn.reshape(C, window * four_fin), conv_a,
                      we.reshape(C, k * two_f), a_merge], dim=1)


# bytes of the product scratch P per chunk of clouds
_P_BUDGET = 1 << 30


def head_kernel(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
                pcat, ppoint, k: int, window: int):
    """Launch ``csrc/edge_head.cu`` (CUDA tensors, checked by
    :func:`edge_head`): the kNN, then per chunk of clouds the product
    ``P = x @ W_all`` and the gather pass."""
    B, N, C = x.shape
    cf = x_knn.shape[-1]
    hk = k // 2
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    _lib.check_rows(B, 1, "edge_head")
    # the product's operands: depth and columns padded to 16-byte rows
    c4 = -(-C // 4) * 4
    w_all = pack_head_weights(wn_flat, conv_a, a_merge, wen, k, window)
    ld = -(-w_all.shape[1] // 4) * 4
    w_all = torch.nn.functional.pad(
        w_all, (0, ld - w_all.shape[1], 0, c4 - C)).contiguous()
    xa = (_lib.aligned(x) if c4 == C
          else torch.nn.functional.pad(x, (0, c4 - C)).contiguous())
    pb_point, pb_merge = _lib.aligned(pb_point), _lib.aligned(pb_merge)
    chunk = max(1, min(B, _P_BUDGET // (N * ld * 4),
                       _lib.MAX_GRID_Y * 128 // N))
    grid = 2 * _lib.sm_count(dev)
    parts = -(-B // chunk) * grid
    P = torch.empty(chunk * N, ld, **f32)
    stats_part = torch.empty(parts, 2, four_fin, **f32)
    idx = torch.empty(B, N, k, device=dev, dtype=torch.int32)
    inte = torch.empty(B, N, hk * four_fin, **f32)
    partial = torch.empty(B, N, two_f, **f32)
    stats = torch.empty(2, four_fin, **f32)
    gated = pcat is not None
    if gated:
        wfea = torch.empty(B, N, k * PROJ // 2, **f32)
        wxyz = torch.empty(B, N, k * PROJ // 2, **f32)
        wstats = torch.empty(2, k * PROJ, **f32)
        w_part = torch.empty(parts, 2, k * PROJ, **f32)
    else:
        wfea = wxyz = wstats = w_part = None
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_edge_head(
        p(xa), p(x_knn), B, N, c4, cf, k, p(w_all), ld, four_fin, two_f,
        p(pb_point), p(pb_merge), p(pcat), p(ppoint), p(idx), p(inte),
        p(partial), p(stats), p(wfea), p(wxyz), p(wstats), p(P), chunk,
        grid, p(stats_part), p(w_part), _lib.stream_handle(dev)),
        "pdgn_edge_head")
    _lib.LAUNCHES["edge_head"] += 1
    return idx, inte, partial, stats, wfea, wxyz, wstats


def pack_head_bwd_weights(wn_flat, conv_a, a_merge, wen, k: int,
                          window: int):
    """The backward's product operands, blocks zero-padded to 16-byte rows
    (``c4``, ``ldf``, ``t4``: C, 4Fin, 2F rounded up to 4): ``W_conv =
    [Wn_0^T; ..; Wn_{window-1}^T; conv_a^T]`` of shape ``((window+1)*ldf,
    c4)``, so that ``Gc @ W_conv`` with ``Gc = [A_0 | .. | S]`` is the
    window conv's input gradient, and ``W_merge = [wen_0; ..; wen_{k-1};
    a_merge]^T`` of shape ``(t4, (k+1)*c4)``."""
    C, four_fin = conv_a.shape
    two_f = a_merge.shape[-1]
    c4, ldf, t4 = _lib.up4(C), _lib.up4(four_fin), _lib.up4(two_f)
    pad = torch.nn.functional.pad
    w_conv = torch.cat([wn_flat.reshape(window, C, four_fin), conv_a[None]])
    w_conv = pad(w_conv, (0, ldf - four_fin, 0, c4 - C)).transpose(1, 2)
    w_merge = torch.cat([wen, a_merge]).reshape(k + 1, C, two_f)
    w_merge = pad(w_merge, (0, t4 - two_f, 0, c4 - C)).permute(2, 0, 1)
    return (w_conv.reshape((window + 1) * ldf, c4).contiguous(),
            w_merge.reshape(t4, (k + 1) * c4).contiguous())


def unpack_head_bwd_grads(d_wconv, d_wmerge, C: int, four_fin: int,
                          two_f: int, k: int, window: int):
    """``d_wconv (c4, (window+1)*ldf) = x^T Gc`` and ``d_wmerge ((k+1)*c4,
    t4)`` cut back to ``d_wn_flat, d_conv_a, d_a_merge, d_wen``."""
    c4, ldf, t4 = _lib.up4(C), _lib.up4(four_fin), _lib.up4(two_f)
    d_wc = d_wconv.reshape(c4, window + 1, ldf)[:C, :, :four_fin]
    d_wc = d_wc.permute(1, 0, 2).reshape((window + 1) * C, four_fin)
    d_wm = d_wmerge.reshape(k + 1, c4, t4)[:, :C, :two_f]
    d_wm = d_wm.reshape((k + 1) * C, two_f)
    return d_wc[:window * C], d_wc[window * C:], d_wm[k * C:], d_wm[:k * C]


def head_bwd_kernel(x, idx, inte, wn_flat, conv_a, a_merge, wen, pcat,
                    ppoint, cts, k: int):
    """Launch ``csrc/edge_head_bwd.cu``. ``cts`` are the cotangents of
    ``inte, partial, stats`` and, gated, ``wfea, wxyz, wstats``. Returns
    the gradients of ``x, wn_flat, conv_a, pb_point, a_merge, wen,
    pb_merge, pcat, ppoint`` (the last two ``None`` for the plain stage).

    The products' operands go by 16-byte ``cp.async`` granules: x,
    ``d_partial`` and the weight blocks are zero-padded to ``c4``, ``t4``
    and ``ldf`` columns, and the padded gradients are cut back here."""
    B, N, C = x.shape
    hk = k // 2
    window = hk + 1
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    rows = B * N
    _lib.check_rows(rows, 128, "edge_head_bwd")
    c4, ldf, t4 = _lib.up4(C), _lib.up4(four_fin), _lib.up4(two_f)
    pad = torch.nn.functional.pad
    w_conv, w_merge = pack_head_bwd_weights(wn_flat, conv_a, a_merge, wen, k,
                                            window)
    xp = _lib.aligned(pad(x, (0, c4 - C)).contiguous())
    gated = pcat is not None
    d_inte, d_stats = (_lib.aligned(c.contiguous()) for c in cts[0:3:2])
    d_partial = _lib.aligned(pad(cts[1], (0, t4 - two_f)).contiguous())
    inte = _lib.aligned(inte)
    d_wfea = d_wxyz = d_wstats = None
    if gated:
        d_wfea, d_wxyz, d_wstats = (c.contiguous() for c in cts[3:6])
    gw, mc = (window + 1) * ldf, (k + 1) * c4
    d_x = torch.empty(rows, c4, **f32)
    d_wconv = torch.empty(c4, gw, **f32)
    d_wmerge = torch.empty(mc, t4, **f32)
    d_pb_point = torch.empty(B, four_fin, **f32)
    d_pb_merge = torch.empty(B, two_f, **f32)
    d_pcat = torch.empty(B, N, PROJ, **f32) if gated else None
    d_ppoint = torch.empty(B, N, PROJ, **f32) if gated else None
    gc = torch.empty(rows, gw, **f32)
    dm = torch.empty(rows, mc, **f32)
    dxm = torch.empty(rows, c4, **f32)
    splits = -(-rows // _lib.TN_SPLIT_ROWS)
    tn_scratch = torch.empty(splits * max(c4 * gw, mc * t4), **f32)
    nbr = (idx + N * torch.arange(B, **i32)[:, None, None]).contiguous()
    count = torch.empty(rows, **i32)
    cursor = torch.empty(rows, **i32)
    offsets = torch.empty(rows + 1, **i32)
    entries = torch.empty(rows * k, **i32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_edge_head_bwd(
        p(xp), p(idx), p(nbr), p(inte), B, N, c4, k, four_fin, two_f, ldf, t4,
        p(w_conv), p(w_merge), p(d_inte), p(d_partial), p(d_stats), p(pcat),
        p(ppoint), p(d_wfea), p(d_wxyz), p(d_wstats), p(d_x), p(d_wconv),
        p(d_wmerge), p(d_pb_point), p(d_pb_merge), p(d_pcat), p(d_ppoint),
        p(gc), p(dm), p(dxm), p(tn_scratch), p(count), p(cursor),
        p(offsets), p(entries), _lib.stream_handle(dev)),
        "pdgn_edge_head_bwd")
    _lib.LAUNCHES["edge_head_bwd"] += 1
    d_wn, d_ca, d_am, d_wen = unpack_head_bwd_grads(
        d_wconv, d_wmerge, C, four_fin, two_f, k, window)
    return (d_x[:, :C].reshape(B, N, C), d_wn, d_ca, d_pb_point, d_am,
            d_wen, d_pb_merge, d_pcat, d_ppoint)


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
        if k > MAX_K:
            raise ValueError(f"edge_head kernel: k={k} > MAX_K={MAX_K} "
                             f"(k + 1 neighbours, at most 128)")
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


# sha256 of head_bits()'s outputs from the head's kernels as they were
# before its product moved into the shared core (csrc/tf32x3_gemm.cuh): the
# move keeps every bit. compare_head_bits.py sets this checkout's digest
# beside another checkout's.
HEAD_BITS = "b419db1eeafa0979dfe8c64a02336c79b567e869ac46fd5bb683a5a58ad7f966"


def head_bits(dev, head=None) -> str:
    """The outputs of ``head`` (this module's :func:`edge_head` by default)
    on operands drawn with numpy at stage-4 widths, B=2, gated: the sha256
    of their bytes (graph, inte, partial, sums, weight-net rows). No torch
    arithmetic runs before the kernels, so on a CUDA device the digest
    depends on the kernels' bits alone."""
    import hashlib

    import numpy as np

    head = head or edge_head
    rng = np.random.RandomState(2024)
    B, N, C, cf, four_fin, two_f, k = 2, 1024, 128, 256, 1024, 512, 10
    window = k // 2 + 1

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    out = head(r(B, N, C), r(B, N, cf), r(window * C, four_fin, scale=0.03),
               r(C, four_fin, scale=0.03), r(B, four_fin, scale=0.1),
               r(C, two_f, scale=0.03), r(k * C, two_f, scale=0.03),
               r(B, two_f, scale=0.1), r(B, N, 32), r(B, N, 32), k, window)
    digest = hashlib.sha256()
    for o in out:
        digest.update(o.cpu().numpy().tobytes())
    return digest.hexdigest()
