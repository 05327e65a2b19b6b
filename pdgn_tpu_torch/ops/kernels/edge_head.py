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

bf16 ``x`` (the generator's ``--compute_dtype bfloat16``) takes the
kernels' bf16 instances: ``x_knn``, ``pcat`` and ``ppoint`` in bf16, the
weights in fp32 (rounded to bf16 inside the function, so that their
gradients stay fp32), ``pb_point``/``pb_merge`` in fp32; the graph of the
bf16 values (fp32 norms of the upcast), products accumulated in fp32,
``inte``, ``wfea`` and ``wxyz`` rounded to bf16, ``partial`` and the sums
(of the rounded values) fp32. Its backward is ``csrc/edge_head_bwd.cu``'s
bf16 instance on a CUDA tensor and :func:`head_bwd_plain_bf16`, written at
the same rounding points, on a CPU tensor: the TPU kernel's
(``_head_bwd_kernel``), not those of autograd through the bf16 forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from pdgn_tpu_torch.models.layers import (cast, matmul_f32, round_bf16,
                                          upcast)
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
    ``wstats (2, k*32)`` (else ``None``s). With bf16 ``x`` (and weights,
    ``pcat``, ``ppoint``) the products accumulate in fp32, ``inte`` and the
    weight-net rows are rounded to bf16 and the sums taken of the rounded
    values (``_head_reference_given_idx`` in bf16).
    """
    B, N, C = x.shape
    hk = k // 2
    four_fin = conv_a.shape[-1]
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else None

    nbr = grouping(x, idx)                                # (B, N, k, C)
    nbr_flat = nbr.reshape(B, N, k * C)
    partial = (matmul_f32(x, a_merge) + matmul_f32(nbr_flat, wen)
               + pb_merge[:, None, :])

    point = matmul_f32(x, conv_a) + pb_point[:, None, :]
    wnr = wn_flat.reshape(window, C, four_fin)
    parts = []
    for wp in range(hk):
        y = point
        for t in range(window):
            y = y + matmul_f32(nbr[:, :, wp + t, :], wnr[t])
        parts.append(cast(dt, y))
    inte = torch.cat(parts, dim=-1)                       # (B, N, hk*4Fin)
    inte4 = upcast(inte.reshape(B, N, hk, four_fin))
    stats = torch.stack([inte4.sum(dim=(0, 1, 2)),
                         (inte4 * inte4).sum(dim=(0, 1, 2))])
    if pcat is None:
        return inte, partial, stats, None, None, None

    # weight-net front in the (window, j) slot order
    idx_b = idx.reshape(B, N, 2, hk).transpose(2, 3).reshape(B, N, k)
    half = PROJ // 2
    wrow = cast(dt, upcast(grouping(pcat, idx_b))
                + upcast(ppoint)[:, :, None, :])          # (B, N, k, 32)
    wfea = wrow[..., :half].reshape(B, N, k * half)
    wxyz = wrow[..., half:].reshape(B, N, k * half)
    wf = upcast(wrow)
    wstats = torch.stack([wf.sum(dim=(0, 1)).reshape(k * PROJ),
                          (wf * wf).sum(dim=(0, 1)).reshape(k * PROJ)])
    return inte, partial, stats, wfea, wxyz, wstats


def head_plain(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
               pcat, ppoint, k: int, window: int):
    """Plain PyTorch head: exact kNN on ``x_knn`` (norm expansion in fp32,
    of the upcast of a bf16 ``x_knn``; row minimum dropped) + the
    fixed-graph body."""
    idx = knn_exclude_first(self_pairwise_sqdist(upcast(x_knn)), k)
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


def pack_head_weights_bf16(wn_flat, conv_a, a_merge, wen, k: int,
                           window: int):
    """The bf16 instance's product operands, K-major for its gather-first
    kernel: ``W_conv^T = [Wn_0 | .. | Wn_{window-1} | conv_a]^T`` of shape
    ``(4Fin, (window+1)*cp)`` and ``W_merge^T = [We_0 | .. | We_{k-1} |
    A]^T`` of shape ``(2F, (k+1)*cp)``, bf16, each slot's block of C rows
    zero-padded to ``cp = up64(C)``: window ``wp``'s ``inte`` is ``[x[idx[:,
    wp]] | .. | x[idx[:, wp+window-1]] | x] @ W_conv + pb_point`` and
    ``partial`` is ``[x[idx[:, 0]] | .. | x[idx[:, k-1]] | x] @ W_merge +
    pb_merge``, with x zero-padded to ``cp`` channels."""
    C, four_fin = conv_a.shape
    two_f = a_merge.shape[-1]
    cp = _lib.up64(C)
    pad = torch.nn.functional.pad
    w_conv = torch.cat([wn_flat.reshape(window, C, four_fin), conv_a[None]])
    w_conv = pad(w_conv, (0, 0, 0, cp - C)).permute(2, 0, 1)
    w_merge = torch.cat([wen.reshape(k, C, two_f), a_merge[None]])
    w_merge = pad(w_merge, (0, 0, 0, cp - C)).permute(2, 0, 1)
    bf = torch.bfloat16
    return (w_conv.reshape(four_fin, (window + 1) * cp).to(bf).contiguous(),
            w_merge.reshape(two_f, (k + 1) * cp).to(bf).contiguous())


# bytes of the fp32 instance's product scratch P per chunk of clouds
_P_BUDGET = 1 << 30


def head_kernel(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
                pcat, ppoint, k: int, window: int):
    """Launch ``csrc/edge_head.cu`` (CUDA tensors, checked by
    :func:`edge_head`): for fp32 ``x`` the kNN, then per chunk of clouds the
    product ``P = x @ W_all`` and the gather pass; bf16 ``x`` takes the
    gather-first instance (:func:`head_kernel_bf16`)."""
    if x.dtype == torch.bfloat16:
        return head_kernel_bf16(x, x_knn, wn_flat, conv_a, pb_point,
                                a_merge, wen, pb_merge, pcat, ppoint, k,
                                window)
    _lib.instance(x)
    B, N, C = x.shape
    cf = x_knn.shape[-1]
    hk = k // 2
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    _lib.check_rows(B, 1, "edge_head")
    # the product's operands: depth and columns padded to 16-byte rows (4
    # fp32)
    c4 = _lib.up4(C)
    w_all = pack_head_weights(wn_flat, conv_a, a_merge, wen, k, window)
    ld = _lib.up4(w_all.shape[1])
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


def head_kernel_bf16(x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen,
                     pb_merge, pcat, ppoint, k: int, window: int):
    """Launch ``pdgn_edge_head_bf16``, the gather-first instance: the graph
    on the fp32 upcast of ``x_knn``, then one persistent kernel that
    gathers the neighbours' rows of bf16 ``x`` and multiplies them by the
    packed weights (:func:`pack_head_weights_bf16`) on the tensor cores,
    writing ``inte`` (rounded to bf16), ``partial`` and the sums; no
    product scratch. Gated, the weight-net rows by a light pass."""
    B, N, C = x.shape
    cf = x_knn.shape[-1]
    hk = k // 2
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    bf = torch.bfloat16
    f32 = dict(device=dev, dtype=torch.float32)
    io = dict(device=dev, dtype=bf)
    if B * N * k >= 2 ** 31:
        raise ValueError(f"edge_head bf16: {B * N} rows x k={k} exceed one "
                         f"launch; use a smaller batch")
    cp = _lib.up64(C)
    w_conv, w_merge = pack_head_weights_bf16(wn_flat, conv_a, a_merge, wen,
                                             k, window)
    xa = (_lib.aligned(x) if cp == C
          else torch.nn.functional.pad(x, (0, cp - C)).contiguous())
    grid = _lib.sm_count(dev)
    stats_part = torch.empty(grid, 2, four_fin, **f32)
    idx = torch.empty(B, N, k, device=dev, dtype=torch.int32)
    inte = torch.empty(B, N, hk * four_fin, **io)
    partial = torch.empty(B, N, two_f, **f32)
    stats = torch.empty(2, four_fin, **f32)
    if pcat is not None:
        wfea = torch.empty(B, N, k * PROJ // 2, **io)
        wxyz = torch.empty(B, N, k * PROJ // 2, **io)
        wstats = torch.empty(2, k * PROJ, **f32)
        w_part = torch.empty(grid, 2, k * PROJ, **f32)
    else:
        wfea = wxyz = wstats = w_part = None
    xk = torch.empty(B, N, cf, **f32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_edge_head_bf16(
        p(xa), p(x_knn), B, N, cp, cf, k, p(w_conv), p(w_merge), four_fin,
        two_f, p(pb_point), p(pb_merge), p(pcat), p(ppoint), p(idx),
        p(inte), p(partial), p(stats), p(wfea), p(wxyz), p(wstats), grid,
        p(stats_part), p(w_part), p(xk), _lib.stream_handle(dev)),
        "pdgn_edge_head_bf16")
    _lib.LAUNCHES["edge_head_bf16"] += 1
    return idx, inte, partial, stats, wfea, wxyz, wstats


def pack_head_bwd_weights(wn_flat, conv_a, a_merge, wen, k: int,
                          window: int):
    """The fp32 backward's product operands, blocks zero-padded to 16-byte
    rows (``c4``, ``ldf``, ``t4``: C, 4Fin, 2F rounded up to 4): ``W_conv =
    [Wn_0^T; ..; Wn_{window-1}^T; conv_a^T]`` of shape ``((window+1)*ldf, c4)``, so that ``Gc @ W_conv``
    with ``Gc = [A_0 | .. | S]`` is the window conv's input gradient, and
    ``W_merge = [wen_0; ..; wen_{k-1}; a_merge]^T`` of shape ``(t4,
    (k+1)*c4)``."""
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
    and ``ldf`` columns, and the padded gradients are cut back here. bf16
    ``x`` launches the bf16 instance (:func:`head_bwd_kernel_bf16`)."""
    if x.dtype == torch.bfloat16:
        return head_bwd_kernel_bf16(x, idx, inte, wn_flat, conv_a, a_merge,
                                    wen, pcat, ppoint, cts, k)
    _lib.instance(x)
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


# depth columns of a stage of the bf16 backward's d_x kernel (kXK in
# csrc/edge_head_bwd.cu, which checks the ldk it is given against it): each
# block of w_dx is 4Fin rounded up to it
BWD_DX_CHUNK = 128


def pack_head_bwd_weights_bf16(wn_flat, conv_a, a_merge, wen, k: int,
                               window: int):
    """The bf16 backward's product operands, K-major bf16 for ``wgmma``:
    ``w_dx`` of shape ``(c8, (window+1)*ldk)``, row ``c`` holding ``[Wn_0[c]
    | .. | Wn_{window-1}[c] | conv_a[c]]`` in blocks of ``ldk`` (4Fin
    rounded up to :data:`BWD_DX_CHUNK`), so that ``[A_0 | .. | S] @ w_dx.T``
    is the window conv's input gradient; and ``w_dm`` of shape
    ``((k+1)*c8, t8)``, row ``j*c8 + c`` holding ``wen_j[c]`` (``j < k``) or
    ``a_merge[c]``, so that ``d_partial @ w_dm.T`` is every neighbour
    block's merge cotangent. ``c8``, ``t8``: C and 2F rounded up to 8;
    zero pads."""
    C, four_fin = conv_a.shape
    two_f = a_merge.shape[-1]
    c8, t8 = _lib.up8(C), _lib.up8(two_f)
    ldk = -(-four_fin // BWD_DX_CHUNK) * BWD_DX_CHUNK
    pad = torch.nn.functional.pad
    bf = torch.bfloat16
    w_dx = torch.cat([wn_flat.reshape(window, C, four_fin), conv_a[None]])
    w_dx = pad(w_dx, (0, ldk - four_fin, 0, c8 - C)).permute(1, 0, 2)
    w_dm = torch.cat([wen.reshape(k, C, two_f), a_merge[None]])
    w_dm = pad(w_dm, (0, t8 - two_f, 0, c8 - C))
    return (w_dx.reshape(c8, (window + 1) * ldk).to(bf).contiguous(),
            w_dm.reshape((k + 1) * c8, t8).to(bf).contiguous())


def unpack_head_bwd_grads_bf16(d_wn, d_ca, d_wm, C: int, four_fin: int,
                               two_f: int, k: int, window: int):
    """The bf16 backward's weight gradients, ``d_wn (window*c8, ld8)``,
    ``d_ca (c8, ld8)`` and ``d_wm ((k+1)*c8, t8)`` (rows ``t*c8 + c`` or
    ``j*c8 + c``), cut back to ``d_wn_flat, d_conv_a, d_a_merge, d_wen``."""
    c8 = _lib.up8(C)
    d_wn = d_wn.reshape(window, c8, -1)[:, :C, :four_fin]
    d_wm = d_wm.reshape(k + 1, c8, -1)[:, :C, :two_f]
    return (d_wn.reshape(window * C, four_fin), d_ca[:C, :four_fin],
            d_wm[k], d_wm[:k].reshape(k * C, two_f))


def head_bwd_splits_bf16(rows: int, C: int, four_fin: int, two_f: int,
                         k: int, sms: int):
    """The row splits of the bf16 backward's three weight products (``d_wn``,
    ``d_conv_a``, ``d_[wen; a_merge]``) on a card of ``sms`` SMs: each
    output tile is 128 rows (of C, per tap) by 256 columns, each stage 64
    rows of the reduction (``hk`` blocks of them for ``d_wn``)."""
    hk, window = k // 2, k // 2 + 1
    mt = -(-_lib.up8(C) // 128)
    nf, nm = -(-_lib.up8(four_fin) // 256), -(-_lib.up8(two_f) // 256)
    blocks = -(-rows // 64)
    split = _lib.product_splits
    return (split(window * mt * nf, hk * blocks, sms),
            split(mt * nf, blocks, sms),
            split((k + 1) * mt * nm, blocks, sms))


def head_bwd_rows_per_block(N: int, ld8: int) -> int:
    """Rows a block of the bf16 backward's dy pass: the largest of 8, 4, 2
    that divides N and whose rows' fp32 S (``ld8`` columns) fit in 48 KB,
    else 1 (passed to ``pdgn_edge_head_bwd_bf16``, which sizes its grid and
    ``spart`` by it). The bias gradient sums S over a block's rows in row
    order, then over the blocks in order."""
    fits = (r for r in (8, 4, 2) if N % r == 0 and r * ld8 * 4 <= 48 << 10)
    return next(fits, 1)


def head_bwd_kernel_bf16(x, idx, inte, wn_flat, conv_a, a_merge, wen, pcat,
                         ppoint, cts, k: int):
    """Launch ``pdgn_edge_head_bwd_bf16``: bf16 ``x``, ``inte``, ``pcat``,
    ``ppoint`` and the cotangents of the bf16 outputs; the weights (fp32
    or bf16) rounded to bf16 here, ``d_partial`` rounded to bf16 for its
    products (the TPU kernel's ``_bf`` points) and kept fp32 for its sums.
    Same returns as :func:`head_bwd_kernel`: ``d_x``, ``d_pcat``,
    ``d_ppoint`` in bf16, the rest fp32. Operands padded to 8 bf16 (16
    bytes)."""
    B, N, C = x.shape
    hk = k // 2
    window = hk + 1
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dev = x.device
    bf = torch.bfloat16
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    rows = B * N
    _lib.check_rows(rows, 128, "edge_head_bwd")
    up = _lib.up8
    c8, ld8, t8 = up(C), up(four_fin), up(two_f)
    pad = torch.nn.functional.pad
    w_dx, w_dm = pack_head_bwd_weights_bf16(wn_flat, conv_a, a_merge, wen,
                                            k, window)
    xp = _lib.aligned(x.contiguous() if C == c8 else pad(x, (0, c8 - C)))
    gated = pcat is not None
    d_inte, d_partial, d_stats = (c.contiguous() for c in cts[:3])
    for name, c, dt in (("d_inte", d_inte, bf), ("d_partial", d_partial,
                                                  torch.float32),
                        ("d_stats", d_stats, torch.float32)):
        if c.dtype != dt:
            raise TypeError(f"edge_head_bwd bf16: {name} must be {dt}, got "
                            f"{c.dtype}")
    d_inte = _lib.aligned(d_inte)
    dpart_b = d_partial.to(bf)
    if t8 != two_f:
        dpart_b = pad(dpart_b, (0, t8 - two_f))
    dpart_b = _lib.aligned(dpart_b)
    inte = _lib.aligned(inte)
    d_wfea = d_wxyz = d_wstats = None
    if gated:
        d_wfea, d_wxyz, d_wstats = (c.contiguous() for c in cts[3:6])
        if d_wfea.dtype != bf or d_wxyz.dtype != bf:
            raise TypeError("edge_head_bwd bf16: the weight-net rows' "
                            "cotangents must be bfloat16")
    sms = _lib.sm_count(dev)
    splits = head_bwd_splits_bf16(rows, C, four_fin, two_f, k, sms)
    mc = (k + 1) * c8
    d_x = torch.empty(rows, c8, device=dev, dtype=bf)
    d_wn = torch.empty(window * c8, ld8, **f32)
    d_ca = torch.empty(c8, ld8, **f32)
    d_wm = torch.empty(mc, t8, **f32)
    d_pb_point = torch.empty(B, four_fin, **f32)
    d_pb_merge = torch.empty(B, two_f, **f32)
    d_pcat = torch.empty(B, N, PROJ, device=dev, dtype=bf) if gated else None
    d_ppoint = torch.empty(B, N, PROJ, device=dev, dtype=bf) if gated else None
    dyb = torch.empty(rows, hk, ld8, device=dev, dtype=bf)
    sb = torch.empty(rows, ld8, device=dev, dtype=bf)
    xg = torch.empty(rows, k + 1, c8, device=dev, dtype=bf)
    rpb = head_bwd_rows_per_block(N, ld8)
    spart = torch.empty(rows // rpb, four_fin, **f32)
    dm = torch.empty(rows, mc, **f32)
    dxm = torch.empty(rows, c8, **f32)
    part = torch.empty(max(splits[0] * window * c8 * ld8,
                           splits[1] * c8 * ld8, splits[2] * mc * t8), **f32)
    counter = torch.empty(1, **i32)
    dec = torch.empty(rows * k, 2, **i32)
    nbr = (idx + N * torch.arange(B, **i32)[:, None, None]).contiguous()
    count = torch.empty(rows, **i32)
    cursor = torch.empty(rows, **i32)
    offsets = torch.empty(rows + 1, **i32)
    entries = torch.empty(rows * k, **i32)
    p = _lib.ptr
    _lib.check(_lib.library().pdgn_edge_head_bwd_bf16(
        p(xp), p(idx), p(nbr), p(inte), B, N, c8, k, four_fin, two_f, ld8, t8,
        p(w_dx), p(w_dm), p(d_inte), p(d_partial), p(dpart_b), p(d_stats),
        p(pcat), p(ppoint), p(d_wfea), p(d_wxyz), p(d_wstats), p(d_x),
        p(d_wn), p(d_ca), p(d_wm), p(d_pb_point), p(d_pb_merge), p(d_pcat),
        p(d_ppoint), p(dyb), p(spart), p(sb), p(xg), p(dm), p(dxm), p(part),
        p(counter), p(dec), p(count), p(cursor), p(offsets), p(entries), sms,
        rpb, w_dx.shape[1] // (window + 1), *splits,
        _lib.stream_handle(dev)), "pdgn_edge_head_bwd_bf16")
    _lib.LAUNCHES["edge_head_bwd_bf16"] += 1
    d_wn, d_ca, d_am, d_wen = unpack_head_bwd_grads_bf16(
        d_wn, d_ca, d_wm, C, four_fin, two_f, k, window)
    return (d_x[:, :C].reshape(B, N, C), d_wn, d_ca, d_pb_point, d_am,
            d_wen, d_pb_merge, d_pcat, d_ppoint)


def head_bwd_plain_bf16(x, idx, inte, wn_flat, conv_a, a_merge, wen, pcat,
                        ppoint, cts, k: int, window: int):
    """The bf16 backward's plain version, at the bf16 instance's rounding
    points (the TPU kernel's ``_bf`` points on the gathered design of
    ``csrc/edge_head_bwd.cu``): per window ``dy = d_inte + ds0 +
    2*inte*ds1`` in fp32, ``S`` its sum over the windows (fp32, the bias
    gradient's; rounded for the product), ``A_t`` the sum over the entries
    naming a row of the bf16-rounded ``dy`` (split into two bf16 parts for
    the products, ``A = A_hi + A_lo``); ``d_x = dxm + [A_hi | S | A_lo] @
    [Wn; conv_a; Wn]^T`` rounded to bf16, ``dxm`` the merge's fp32
    cotangents ``d_partial_b @ W_merge_b`` gathered; the weight gradients
    ``x^T [A_hi + A_lo | S]`` and ``[x[idx] | x]^T d_partial_b`` in fp32;
    ``d_pcat`` the sum of the bf16-rounded ``d_wrow`` over the entries,
    ``d_ppoint`` their fp32 sum over the slots, both stored in bf16. Same
    inputs and returns as :func:`head_bwd_kernel`."""
    B, N, C = x.shape
    hk = k // 2
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    rows = B * N
    xf = x.float().reshape(rows, C)
    d_inte, d_partial, d_stats = cts[0].float(), cts[1].float(), cts[2]
    inte4 = inte.float().reshape(rows, hk, four_fin)
    dy = ((d_inte.reshape(rows, hk, four_fin) + d_stats[0])
          + (2.0 * inte4) * d_stats[1])
    S = dy[:, 0]
    for wp in range(1, hk):
        S = S + dy[:, wp]
    dyb = round_bf16(dy).reshape(-1, four_fin)
    gidx = (idx.long() + N * torch.arange(B, device=x.device)[:, None, None]
            ).reshape(rows, k)
    gc = []
    for t in range(window):
        a = torch.zeros(rows, four_fin, dtype=torch.float32, device=x.device)
        gc.append(a.index_add_(0, gidx[:, t:t + hk].reshape(-1), dyb))
    a = torch.stack(gc, dim=1)                           # (rows, w, 4Fin)
    a_hi = round_bf16(a)
    # [A_hi | S_b | A_lo]: A split in two bf16 parts, S rounded once
    gcb = torch.cat([a_hi, round_bf16(S)[:, None], round_bf16(a - a_hi)],
                    dim=1)
    wn_b = round_bf16(wn_flat.float()).reshape(window, C, four_fin)
    ca_b = round_bf16(conv_a.float())
    w_conv = torch.cat([wn_b, ca_b[None], wn_b])         # (2w+1, C, 4Fin)
    dpart_b = round_bf16(d_partial.reshape(rows, two_f))
    w_merge = torch.cat([round_bf16(wen.float()), round_bf16(a_merge.float())]
                        ).reshape(k + 1, C, two_f)
    dm = torch.einsum("rf,jcf->rjc", dpart_b, w_merge)   # (rows, k+1, C)
    dxm = dm[:, k].index_add(0, gidx.reshape(-1),
                             dm[:, :k].reshape(-1, C))
    acc = torch.einsum("rtf,tcf->rc", gcb, w_conv)
    d_x = (dxm + acc).to(torch.bfloat16).reshape(B, N, C)
    d_wc = torch.einsum("rc,rtf->tcf", xf, gcb)          # (2w+1, C, 4Fin)
    nbr = xf[gidx]                                        # (rows, k, C)
    d_wen = torch.einsum("rjc,rf->jcf", nbr, dpart_b).reshape(k * C, two_f)
    d_am = xf.T @ dpart_b
    d_pb = S.reshape(B, N, four_fin).sum(dim=1)
    d_pbm = d_partial.reshape(B, N, two_f).sum(dim=1)
    d_wn = d_wc[:window] + d_wc[window + 1:]
    out = (d_x, d_wn.reshape(window * C, four_fin), d_wc[window], d_pb, d_am,
           d_wen, d_pbm)
    if pcat is None:
        return out + (None, None)
    d_wfea, d_wxyz, d_wstats = cts[3:6]
    half = PROJ // 2
    # slot s reads extraction index (s%2)*hk + s//2
    order = torch.tensor([(s % 2) * hk + s // 2 for s in range(k)],
                         device=x.device)
    q = gidx[:, order]                                    # (rows, k)
    wrow = pcat.float().reshape(rows, PROJ)[q] + ppoint.float().reshape(
        rows, 1, PROJ)
    base = torch.cat([d_wfea.float().reshape(rows, k, half),
                      d_wxyz.float().reshape(rows, k, half)], dim=-1)
    ws = d_wstats.reshape(2, k, PROJ)
    dwrow = (base + ws[0]) + (2.0 * wrow) * ws[1]         # (rows, k, 32)
    d_pp = dwrow[:, 0]
    for s_ in range(1, k):
        d_pp = d_pp + dwrow[:, s_]
    d_pc = torch.zeros(rows, PROJ, dtype=torch.float32, device=x.device)
    d_pc.index_add_(0, q.reshape(-1), round_bf16(dwrow).reshape(-1, PROJ))
    return out + (d_pc.to(torch.bfloat16).reshape(B, N, PROJ),
                  d_pp.to(torch.bfloat16).reshape(B, N, PROJ))


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
        # fp32 weights of a bf16 head are rounded here (as _head_pallas casts
        # them), so that autograd hands their gradients back in fp32
        w = [t.to(x.dtype) for t in (wn_flat, conv_a, a_merge, wen)]
        args = (x, x_knn, w[0], w[1], pb_point, w[2], w[3], pb_merge,
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
        elif x.dtype == torch.bfloat16:
            g = head_bwd_plain_bf16(x, idx, inte, wn_flat, conv_a, a_merge,
                                    wen, pcat, ppoint, cts, ctx.k,
                                    ctx.window)
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
    three ``None`` for the plain stage). ``x`` float32 or bfloat16: ``x_knn``,
    ``pcat`` and ``ppoint`` in its dtype, the weights and ``pb_*`` float32
    (a bf16 head rounds its weights inside and returns their gradients in
    float32). A CPU ``x`` may also be float64 (an arbiter's dtype), the
    weights then float64 too.
    """
    B, N, C = x.shape
    cf = x_knn.shape[-1]
    four_fin = conv_a.shape[-1]
    two_f = a_merge.shape[-1]
    dt, wdt = x.dtype, torch.float32
    if dt == torch.float64 and x.device.type == "cpu":
        wdt = dt
    elif dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {dt}")
    checks = [("x", x, (B, N, C), dt), ("x_knn", x_knn, (B, N, cf), dt),
              ("wn_flat", wn_flat, (window * C, four_fin), wdt),
              ("conv_a", conv_a, (C, four_fin), wdt),
              ("pb_point", pb_point, (B, four_fin), wdt),
              ("a_merge", a_merge, (C, two_f), wdt),
              ("wen", wen, (k * C, two_f), wdt),
              ("pb_merge", pb_merge, (B, two_f), wdt)]
    if pcat is not None:
        checks += [("pcat", pcat, (B, N, PROJ), dt),
                   ("ppoint", ppoint, (B, N, PROJ), dt)]
    for name, t, shape, dtype in checks:
        _check(name, t, shape, dtype)
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
    ``[xs broadcast | x]``, as the JAX package's exact path does. With bf16
    ``x``, ``x_knn`` is bf16 and the weights and ``pb_*`` stay fp32 (``pb_*``
    from the upcast ``xs``): :func:`edge_head` rounds the weights to bf16,
    as ``_head_pallas`` casts them.
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
        pb_merge = conv_bias.new_zeros(B, two_f)
    else:
        x_knn = torch.cat([xs[:, None, :].expand(B, N, cx), x], dim=-1)
        conv_a = conv_a_full[cx:]
        wn_flat = wn[:, cx:, :].reshape(window * C, four_fin)
        m_point = conv_a_full[:cx] + torch.sum(wn[:, :cx, :], dim=0)
        pb_point = torch.matmul(upcast(xs), m_point) + conv_bias
        a_merge = a_merge_full[cx:]
        wen = wen_full[:, cx:, :].reshape(k * C, two_f)
        m_merge = a_merge_full[:cx] + torch.sum(wen_full[:, :cx, :], dim=0)
        pb_merge = torch.matmul(upcast(xs), m_merge)
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else None
    return (cast(dt, x_knn).contiguous(), wn_flat.contiguous(),
            conv_a.contiguous(), pb_point.contiguous(), a_merge.contiguous(),
            wen.contiguous(), pb_merge.contiguous(), window)


def edge_conv_head(x, conv_kernel, conv_bias, merge_kernel, k: int,
                   pcat=None, ppoint=None, *, xs=None, axis=None):
    """Fused stage head with the JAX entry's interface and returns:
    ``idx, inte, partial, (mean, var)`` and, gated, ``wfea, wxyz,
    fea_stats, xyz_stats`` (``None``s for the plain stage). With an
    ``axis`` (``parallel.sync_bn.DataAxis``) the kernel's fp32 moment sums
    are summed over the ranks, and the counts scaled to the global batch,
    before they divide."""
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

    count, wcount = B * N * hk, B * N * k
    sums = [stats]
    if pcat is not None:
        ws = wstats.reshape(2, k, PROJ)
        sums += [ws[0].sum(dim=0), ws[1].sum(dim=0)]
    if axis is not None:
        sums = axis.sum(sums)
        count, wcount = axis.count(count), axis.count(wcount)
    mean = sums[0][0] / count
    var = sums[0][1] / count - mean * mean
    if pcat is None:
        return idx, inte, partial, (mean, var), None, None, None, None
    wm = sums[1] / wcount
    wv = sums[2] / wcount - wm * wm
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
