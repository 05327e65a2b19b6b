"""Edge-conv stage head: kNN + gathers + window conv + merge partial
(port of pdgn_tpu/ops/pallas/edge_head.py).

:func:`edge_conv_head` keeps the JAX entry's signature and layouts
(``conv_kernel (1, W, 2Cf, 4Fin)`` in block channel order, ``merge_kernel
(2k*2Cf, 2F)`` slot-major), prepares the parameter-side operands as the JAX
entry does, and hands them to :func:`edge_head`. That wrapper launches the
CUDA kernel (``csrc/edge_head.cu``) for CUDA tensors and runs the plain
PyTorch version (:func:`head_plain`: exact kNN + :func:`head_reference_given_idx`)
for CPU tensors.
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
    """The head on prepared operands. CUDA tensors launch the kernel, CPU
    tensors run :func:`head_plain`; anything else raises.

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
    args = (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
            pcat, ppoint, k, window)
    if x.device.type == "cuda":
        if k not in _SUPPORTED_K:
            raise ValueError(f"edge_head kernel: k={k} not in {_SUPPORTED_K}")
        return head_kernel(*args)
    if x.device.type == "cpu":
        return head_plain(*args)
    raise ValueError(f"edge_head: unsupported device {x.device}")


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
