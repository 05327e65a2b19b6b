"""The bf16 gated tail backward's decomposition on the card
(``csrc/bilateral_tail_bwd.cu``, ``pdgn_bilateral_tail_gated_bwd_bf16``),
transcribed in torch over the wrapper's own packing, before the card runs
it:

* ``pack_tail_bwd_weights_bf16``: ``wi`` in bf16, zero-padded to ``t8``
  columns, read as the kernel's 3-D TMA box of 16 channels by ``KS`` slots
  (column ``s * 16 + c`` of a channel block is row ``s * 2Fin + c0 + c``,
  zero past k or 2Fin); ``w2k^T`` zero-padded to ``ldv`` rows, read 16
  rows (channels) a block;
* per channel block: conv_all2's output ``v`` (h against the block's w2k
  rows, plus w2b), dg of the block's slots, the softmax over the slots
  (the maximum, z summed over ascending slots, one reciprocal), walk A (g,
  d_inte, du, dot summed over ascending slots)
  and walk B (dv, zero in the pad columns), each elementwise operation
  rounded on its own;
* the seven channel sums as the kernel adds them: a thread's two rows (g,
  g + 8) slot by slot, a butterfly over g, the four warps in order, then
  the 64-row tiles' partials in order in float64 (``column_reduce``);
* ``d_h = dv w2k^T`` rounded to bf16; ``d_w2k = h^T dv`` and ``d_wi = g^T
  dy`` split over the rows in ``tail_bwd_splits_bf16``'s ranges (stages of
  64 rows), the partials added in split order in float64.

It is held against ``tail_bwd_plain_bf16`` (the card's reference): bf16
outputs within 2 ulps (``bf16_ulps``), fp32 ones rel <= 1e-4, the
slot-logit entries at a kink (``kink_mask``) counted apart as the card
checks count them; and against JAX's ``_bwd_pallas(..., interpret=True)``
on the same numpy inputs at the limits ``test_torch_bf16_train_kernels``
states for the plain version (bf16 2 ulps, fp32 rel 1e-4). k in {2, 10,
12, 14, 16} (the kernel takes k <= ``TAIL_BWD_FAST_K``; wider k stays on
the core's chain), 2Fin odd (65, 17) with 2F = 66, rows that fill no
64-row tile. A packing fault (a slot's rows out of place, a channel block
shifted, a pad that is not zero) moves whole blocks and fails here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (bf16_pair, bf16_ulps, one_torch_thread,  # noqa: F401
                             rel)

from pdgn_tpu.ops.pallas.bilateral_tail import _bwd_pallas
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import (
    TAIL_BWD_FAST_K, kink_mask, pack_tail_bwd_weights_bf16,
    tail_bwd_plain_bf16, tail_bwd_splits_bf16)

BF = torch.bfloat16
F = np.float32
T = torch.from_numpy
J = jnp.asarray
SMS = 132          # the H100's SMs: the splits' boundaries on that card
CB, TILE = 16, 64  # the kernel's channel block and row tile
NAMES = ("d_partial", "d_inte", "d_h", "d_isc", "d_ish", "d_w2k", "d_w2b",
         "d_s2", "d_t2", "d_wi", "d_bias", "g", "dv")


def _leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _case(seed, B, N, k, four_fin, two_f):
    """bf16 inte, h and dy, fp32 weights (rounded inside, as the tail's
    autograd Function hands them on); each as (torch, jax)."""
    rng = np.random.RandomState(seed)
    hk, two_fin = k // 2, four_fin // 2
    inte = bf16_pair(rng.randn(B, N, hk * four_fin))
    h = bf16_pair(rng.randn(B, N, k * 64) * 0.5)
    v = dict(isc=(rng.rand(four_fin) + 0.5).astype(F),
             ish=(rng.randn(four_fin) * 0.1).astype(F),
             w2k=(rng.randn(64, two_fin) * 0.3).astype(F),
             w2b=(rng.randn(two_fin) * 0.1).astype(F),
             s2=(rng.rand(two_fin) + 0.5).astype(F),
             t2=(rng.randn(two_fin) * 0.1).astype(F),
             wi=(rng.randn(hk * four_fin, two_f) * 0.05).astype(F))
    dy = bf16_pair(rng.randn(B, N, two_f))
    return inte, h, v, dy


def _args(inte, h, v, dy):
    return (inte[0], h[0], *(T(v[n]) for n in ("isc", "ish", "w2k", "w2b",
                                                "s2", "t2", "wi")), dy[0])


def _tile_sums(val, rows):
    """``val (rows, k, 16)``'s sums over rows and slots as the kernel adds
    them, one partial a 64-row tile: ``(tiles, 16)``."""
    tiles = -(-rows // TILE)
    v = torch.zeros(tiles * TILE, *val.shape[1:])
    v[:rows] = val
    v = v.reshape(tiles, 4, 2, 8, *val.shape[1:])   # tile, warp, half, g
    p = torch.zeros(tiles, 4, 8, val.shape[-1])
    for s in range(val.shape[1]):
        for half in range(2):
            p = p + v[:, :, half, :, s]
    for b in (1, 2, 4):                             # lanes xor 4, 8, 16
        p = p + p[:, :, torch.arange(8) ^ b]
    out = p[:, 0, 0]
    for w in range(1, 4):
        out = out + p[:, w, 0]
    return out


def _split_sum(stage, stages, splits):
    """``sum_s stage(s)`` as ``product_bf16_kernel`` and ``column_reduce``
    form it: split z's partial over its stages in fp32, the partials added
    in split order in float64, rounded to fp32."""
    total = None
    for z in range(splits):
        part = None
        for s in range(z * stages // splits, (z + 1) * stages // splits):
            v = stage(s)
            part = v if part is None else part + v
        if part is not None:
            total = part.double() if total is None else total + part.double()
    return total.float()


def decomposed(inte, h, isc, ish, w2k, w2b, s2, t2, wi, dy, k, softmax):
    """The gated bf16 backward in the card's decomposition over the
    wrapper's packing (module docstring); the returns of
    ``tail_bwd_kernel_bf16(..., keep_g=True, keep_dv=True)``."""
    B, N, two_f = dy.shape
    rows = B * N
    K = inte.shape[-1]
    two_fin = K // k
    ldg, t8, ldv = _lib.up8(K), _lib.up8(two_f), _lib.up8(two_fin)
    assert k <= TAIL_BWD_FAST_K
    ks = 10 if k <= 10 else 16
    wi_p, w2k_t = (w.float() for w in pack_tail_bwd_weights_bf16(wi, w2k,
                                                                 two_f))
    assert tuple(wi_p.shape) == (K, t8) and not wi_p[:, two_f:].any()
    assert tuple(w2k_t.shape) == (ldv, 64) and not w2k_t[two_fin:].any()
    wi3 = wi_p.reshape(k, two_fin, t8)
    dyp = torch.nn.functional.pad(dy.float().reshape(rows, two_f),
                                  (0, t8 - two_f))
    hf = h.float().reshape(rows, k, 64)
    xf = inte.float().reshape(rows, k, two_fin)
    nb = -(-two_fin // CB)
    tiles = -(-rows // TILE)
    g = torch.zeros(rows, k, nb * CB)
    d_inte = torch.zeros(rows, k, nb * CB)
    dv = torch.zeros(rows, k, nb * CB)
    parts = torch.zeros(7, tiles, nb * CB)
    slot = torch.arange(k)[None, :, None]

    for b in range(nb):
        c0 = b * CB
        nc = min(CB, two_fin - c0)
        cs = slice(c0, c0 + CB)

        def chan(t, off=0):
            out = torch.zeros(CB)
            out[:nc] = t[off + c0:off + c0 + nc]
            return out

        sc, sh, bias = chan(s2), chan(t2), chan(w2b)
        ia = torch.where(slot % 2 == 1, chan(isc, two_fin), chan(isc))
        ib = torch.where(slot % 2 == 1, chan(ish, two_fin), chan(ish))
        wrow = torch.zeros(CB, 64)
        wrow[:min(CB, ldv - c0)] = w2k_t[c0:c0 + CB]
        v = hf @ wrow.T + bias                     # (rows, k, 16)
        upre = v * sc + sh
        u = _leaky(upre)
        x = torch.zeros(rows, k, CB)
        x[..., :nc] = xf[..., c0:c0 + nc]
        box = torch.zeros(ks, CB, t8)
        box[:k, :nc] = wi3[:, c0:c0 + nc]
        dg = (dyp @ box.reshape(ks * CB, t8).T).reshape(rows, ks, CB)[:, :k]
        if not softmax:
            w = u
        else:
            m = u.amax(dim=1, keepdim=True)
            z = torch.zeros(rows, 1, CB)
            for s in range(k):
                z = z + torch.exp(u[:, s:s + 1] - m)
            w = torch.exp(u - m) * (1.0 / z)
        # walk A
        gpre = x * ia + ib
        lg = _leaky(gpre)
        dgw = dg * w
        dgpre = torch.where(gpre >= 0, dgw, 0.01 * dgw)
        du = dg * lg
        duw = du * w
        dot = torch.zeros(rows, 1, CB)
        for s in range(k):
            dot = dot + duw[:, s:s + 1]
        g[..., cs] = lg * w
        d_inte[..., cs] = dgpre * ia
        # walk B
        da = w * (du - dot) if softmax else du
        dpre = torch.where(upre >= 0, da, 0.01 * da)
        out = dpre * sc
        dv[..., cs] = out
        odd = (slot % 2 == 1).float()
        vals = (dgpre * x * (1 - odd), dgpre * x * odd, dgpre * (1 - odd),
                dgpre * odd, dpre * v, dpre, out)
        for i, val in enumerate(vals):
            parts[i, :, cs] = _tile_sums(val, rows)
    sums = parts.double().sum(dim=1).float()[:, :two_fin]
    d_isc = torch.cat([sums[0], sums[1]])
    d_ish = torch.cat([sums[2], sums[3]])
    g = g[..., :two_fin].to(BF).reshape(rows, K)
    d_inte = d_inte[..., :two_fin].to(BF).reshape(inte.shape)
    dv = torch.nn.functional.pad(dv[..., :two_fin].to(BF),
                                 (0, ldv - two_fin)).reshape(rows * k, ldv)

    # conv_all2's backward and d_wi
    d_h = (dv.float() @ w2k_t).to(BF).reshape(h.shape)
    split_wi, split_w2k = tail_bwd_splits_bf16(rows, k, two_fin, two_f, SMS)

    def rows_of(s):
        return slice(s * TILE, (s + 1) * TILE)

    hr, dvf, gf = hf.reshape(rows * k, 64), dv.float(), g.float()
    d_w2k = _split_sum(lambda s: hr[rows_of(s)].T @ dvf[rows_of(s)],
                       -(-rows * k // TILE), split_w2k)[:, :two_fin]
    d_wi = _split_sum(lambda s: gf[rows_of(s)].T @ dyp[rows_of(s), :two_f],
                      tiles, split_wi)
    # d_bias: 256-row chunks in row order, the chunks' sums in order
    dyf = dy.float().reshape(rows, two_f)
    chunk = torch.zeros(-(-rows // 256), two_f)
    for r in range(256):
        chunk[:len(dyf[r::256])] = chunk[:len(dyf[r::256])] + dyf[r::256]
    d_bias = chunk.double().sum(dim=0).float()
    return (dy.float(), d_inte, d_h, d_isc, d_ish, d_w2k, sums[6], sums[4],
            sums[5], d_wi, d_bias, g, dv.reshape(rows, k, ldv)[..., :two_fin])


def _hold(got, want, args, k):
    """``got`` against ``want``: bf16 within 2 ulps, fp32 rel <= 1e-4; dv
    and d_h on the (point, slot) rows free of kink entries, the slot-logit
    sums (and d_w2k) with what the two sides' dv differ by there allowed
    (chip_smoke phase 2bt's rule)."""
    rows = got[12].shape[0]
    kinks = kink_mask(args[1], *args[4:8], k)
    ok = ~kinks.any(-1)
    dd = ((got[12].double() - want[12].double()).abs()
          + (got[12].double().abs() + want[12].double().abs()) * 2.0 ** -8)
    dd = dd * kinks
    s2 = args[6].double().abs()
    h = args[1].double().reshape(rows, k, -1)
    pre = h @ args[4].to(BF).double() + args[5].double()
    allow = {"d_w2b": dd.sum((0, 1)), "d_t2": dd.sum((0, 1)) / s2,
             "d_s2": (dd * pre.abs()).sum((0, 1)) / s2,
             "d_w2k": torch.einsum("rsh,rsc->hc", h.abs(), dd)}
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ("dv", "d_h"):
            g, w = g.reshape(rows, k, -1)[ok], w.reshape(rows, k, -1)[ok]
        if g.dtype == BF:
            assert bf16_ulps(g, w) <= 2.0, (name, bf16_ulps(g, w))
        elif name in allow:
            over = ((g.double() - w.double()).abs() - allow[name]).clamp_min(0)
            e = float(over.max() / w.double().abs().max().clamp_min(1e-12))
            assert e <= 1e-4, (name, e)
        else:
            assert rel(g, w) <= 1e-4, (name, rel(g, w))


@pytest.mark.parametrize("k,four_fin,two_f,N", [
    (2, 32, 16, 40),
    (10, 130, 66, 40),     # 2Fin odd, 2F off a multiple of 8
    (12, 64, 48, 40),      # KS = 16 with 4 slots of padding
    (14, 32, 24, 40),
    (16, 32, 24, 40),      # the widest k: N = 256 columns
    (16, 34, 16, 24)])     # 2Fin odd at the widest k
def test_decomposition_matches_plain(k, four_fin, two_f, N):
    """The transcription against ``tail_bwd_plain_bf16``; 2 x N rows fill
    no 64-row tile."""
    args = _args(*_case(k + four_fin, 2, N, k, four_fin, two_f))
    got = decomposed(*args, k, True)
    want = tail_bwd_plain_bf16(*args, k, True, keep_g=True, keep_dv=True)
    _hold(got, want, args, k)


def test_decomposition_without_softmax():
    """The slot weights taken as they are (``softmax=False``)."""
    k = 6
    args = _args(*_case(3, 2, 40, k, 48, 24))
    want = tail_bwd_plain_bf16(*args, k, False, keep_g=True, keep_dv=True)
    _hold(decomposed(*args, k, False), want, args, k)


def test_decomposition_matches_the_interpret_kernel():
    """The transcription against ``_bwd_pallas(...,
    interpret=True)`` at the plain version's limits
    (``test_torch_bf16_train_kernels``)."""
    k, four_fin, two_f = 6, 16, 16
    inte, h, v, dy = _case(0, 2, 128, k, four_fin, two_f)
    want = _bwd_pallas(inte[1], h[1], *(J(v[n]) for n in (
        "isc", "ish", "w2k", "w2b", "s2", "t2", "wi")), dy[1], k, True, True)
    args = _args(inte, h, v, dy)
    got = decomposed(*args, k, True)
    # _bwd_pallas: dinte, dh, disc, dish, dw2k, dw2b, ds2, dt2, dwi, dbias
    for name, g, wv in zip(NAMES[1:], got[1:11], want):
        wv = np.asarray(wv, np.float32).reshape(tuple(g.shape))
        if g.dtype == BF:
            assert bf16_ulps(g, wv) <= 2.0, (name, bf16_ulps(g, wv))
        else:
            assert rel(g, wv) <= 1e-4, (name, rel(g, wv))
