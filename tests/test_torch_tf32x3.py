"""The arithmetic of the port's tensor-core products, on the CPU.

``csrc/mma_tf32x3.cuh`` runs fp32 products as three TF32 passes: each
operand splits as hi = tf32(a), lo = tf32(a - hi) (``cvt.rna.tf32.f32``:
round to nearest, ties away from zero, the 13 low mantissa bits cleared)
and the product accumulates lo*hi + hi*lo + hi*hi in fp32. A numpy
emulation of that split holds the three-pass product to rel <= 1e-6 of
float64 at the head's product shapes (depth C of stages 1-4) and at
slot_stats' 64 x 64 h^T h, and shows that one TF32 pass misses the
kernels' own limits (the head's rel 1e-4, slot stats' 1e-5), which is why
they take three. The tensor cores truncate their additions: the emulation
does too (and, for the head shapes, also rounds, the split's own
arithmetic), and shows why slot stats' kernel folds its accumulators every
32 rows, and why the shared product core (``csrc/tf32x3_gemm.cuh``) folds
its own every 128 of depth: the gated tail's merge (depth 5,120), the head
backward's ``Gc @ W_conv`` (7,168) and its weight gradients over 4,096-row
splits stay within rel 1e-5 of float64 folded and miss it unfolded; the
tail backward's four products and the gates' slot logits stay within it
too.

``edge_head``'s kernel moves the products ahead of the gather:
``x[idx] @ W = (x @ W)[idx]``. ``x @ pack_head_weights(...)`` followed by
the gather pass's sums, written here in torch in the kernel's order,
reproduces ``head_reference_given_idx`` and the JAX package's
``_head_reference_given_idx`` to rel <= 1e-5 (fp32 products summed in
another order) at every stage's widths, gated and plain, with duplicate
neighbour indices; this pins the packing and the block channel order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel

from pdgn_tpu.ops.pallas.edge_head import _head_reference_given_idx
from pdgn_tpu_torch.ops.kernels.edge_head import (PROJ,
                                                  head_operands,
                                                  head_reference_given_idx,
                                                  pack_head_weights)

# (N, C, cx, 4Fin, 2F) of the generator's stages 1-4 at full width
STAGES = {1: (128, 32, 0, 128, 64), 2: (256, 32, 32, 256, 128),
          3: (512, 64, 64, 512, 256), 4: (1024, 128, 128, 1024, 512)}
K = 10


def tf32_rna(a):
    """``cvt.rna.tf32.f32``: the magnitude rounded to 10 mantissa bits, ties
    away from zero (add half of the dropped unit, clear the 13 low bits)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    hi = tf32_rna(a)
    return hi, tf32_rna(a.astype(np.float32) - hi)


def rtz(x):
    """float64 -> float32 rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def mma_product(a, b, passes, fold=None, add=rtz):
    """``a @ b`` as the tensor cores run it: depth in steps of 8, each
    pass's eight TF32 products (exact) and the accumulator summed and
    rounded to fp32 by ``add`` (the tensor cores truncate, ``rtz``;
    ``mma_tf32x3``'s passes: lo*hi, hi*lo, hi*hi). With ``fold``, the
    accumulator restarts every ``fold`` steps and is added into an fp32
    total with rounding, as slot stats' kernel does every 32 rows."""
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    d = np.zeros_like(total)
    for step, k0 in enumerate(range(0, a.shape[1], 8)):
        for x, y in passes(a[:, k0:k0 + 8], b[k0:k0 + 8]):
            d = add(d + (x.astype(np.float64) @ y.astype(np.float64)))
        if fold and (step + 1) % fold == 0:
            total, d = total + d, np.zeros_like(d)
    return total + d


def three_pass(a, b):
    (ahi, alo), (bhi, blo) = split(a), split(b)
    return ((alo, bhi), (ahi, blo), (ahi, bhi))


def one_pass(a, b):
    return ((tf32_rna(a), tf32_rna(b)),)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                   # TF32's unit at 1.0
    x = np.array([one + ulp / 2, one + ulp / 2 - 2.0 ** -23,
                  -(one + ulp / 2), one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([one + ulp, one, -(one + ulp),
                               one + 2 * ulp], np.float32))
    a = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi, lo = split(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.abs((hi.astype(np.float64) + lo) - a).max() \
        <= 2.0 ** -21 * np.abs(a).max()


def rn(x):
    return x.astype(np.float32)


@pytest.mark.parametrize("add,limit", [(rn, 1e-6), (rtz, 2e-6)])
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_three_passes_keep_fp32_accuracy_at_the_head_shapes(stage, add,
                                                            limit):
    """x (points, C) @ W_all columns of the generator's scale. Rounded
    additions keep 1e-6; the tensor cores' truncated ones cost up to
    ~1.4e-6 at depth 128 (48 of them a product; fp32's own chain of
    products there: ~4e-7)."""
    _, c, cx, _, _ = STAGES[stage]
    rng = np.random.RandomState(stage)
    x = rng.randn(64, c).astype(np.float32)
    w = (rng.randn(c, 256) * (2 * (c + cx) * (K // 2 + 1)) ** -0.5).astype(
        np.float32)
    want = x.astype(np.float64) @ w.astype(np.float64)
    assert rel(mma_product(x, w, three_pass, add=add), want) <= limit
    assert rel(mma_product(x, w, one_pass, add=add), want) > 1e-4


def test_three_passes_keep_fp32_accuracy_for_slot_stats():
    """S = h^T h over 4096 rows of the hidden width 64, summed as the kernel
    sums it: 8 warps of 512 consecutive rows, the mma accumulators folded
    every 32 rows, the warps' partials added in order. Without the folds
    the truncating additions drift past 1e-6; one pass misses slot stats'
    own limit, rel 1e-5."""
    h = np.random.RandomState(5).randn(8 * 512, 64).astype(np.float32) * 0.5
    want = h.T.astype(np.float64) @ h.astype(np.float64)

    def stats(passes, fold):
        got = np.zeros((64, 64), np.float32)
        for w in range(8):
            hw = h[512 * w:512 * (w + 1)]
            got = got + mma_product(hw.T.copy(), hw, passes, fold)
        return rel(got, want)

    assert stats(three_pass, 4) <= 1e-6
    assert stats(three_pass, None) > 1e-6
    assert stats(one_pass, 4) > 1e-5


# tf32x3_gemm.cuh's kGFold: 4 stages of 32, 128 of depth, in k8 steps
FOLD_STEPS = 4 * 32 // 8


@pytest.mark.parametrize("product", ["tail merge", "head bwd Gc W_conv",
                                     "head bwd x^T Gc", "tail bwd dg",
                                     "tail bwd d_wi", "tail bwd d_h",
                                     "tail bwd d_w2k", "tail bwd logits"])
def test_folded_chains_keep_fp32_accuracy(product):
    """The products of the shared core at their stage-4 depths, as the core
    sums them: 8-deep mma steps with truncated additions, accumulators
    folded every FOLD_STEPS into rounded fp32 totals; a transposed product's
    4,096-row splits added in float64 (column_reduce) and rounded. Folded,
    each stays within rel 1e-5 of float64; unfolded, the long chains (depth
    5,120, 7,168 and 4,096-row splits) drift past it (~5e-5). The tail
    backward's products: dg = dy wi^T and d_h = dv w2k^T at depth 512,
    d_wi = g^T dy and d_w2k = h^T dv over 4,096-row splits, and the gates'
    slot logits h_s w2k at depth 64 (one unfolded chain)."""
    rng = np.random.RandomState(len(product))
    splits, fold, drifts = 1, FOLD_STEPS, True
    if product == "tail merge":          # g (rows, 5120) @ wi (5120, 2F)
        depth = 5 * 1024
        a = rng.randn(64, depth).astype(np.float32)
        a = np.maximum(a, 0.01 * a) * rng.rand(64, depth).astype(np.float32)
    elif product == "head bwd Gc W_conv":  # Gc (rows, 7*4Fin) @ W_conv
        depth = 7 * 1024
        a = rng.randn(64, depth).astype(np.float32)
    elif product in ("tail bwd dg", "tail bwd d_h"):  # depth 2F, 2Fin
        depth, drifts = 512, False
        a = rng.randn(64, depth).astype(np.float32)
    elif product == "tail bwd logits":   # h_s (16, 64) @ w2k, never folded
        depth, fold, drifts = 64, None, False
        a = (0.5 * rng.randn(16, depth)).astype(np.float32)
    else:                                # x^T Gc, g^T dy, h^T dv: 2 splits
        depth, splits = 4096, 2
        a = rng.randn(64, splits * depth).astype(np.float32)
        if product == "tail bwd d_wi":   # gated g = LeakyReLU(.) * weight
            a = np.maximum(a, 0.01 * a) * rng.rand(*a.shape).astype(
                np.float32)
    b = (rng.randn(splits * depth, 64) * depth ** -0.5).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)

    def core(fold):
        out = np.zeros(want.shape, np.float64)
        for s in range(splits):
            rows = slice(s * depth, (s + 1) * depth)
            out += mma_product(a[:, rows], b[rows], three_pass, fold)
        return out.astype(np.float32)

    assert rel(core(fold), want) <= 1e-5
    if drifts:
        assert rel(core(None), want) > 1e-5


def gather_sums(P, idx, pb_point, pb_merge, pcat, ppoint, k, window,
                four_fin, two_f):
    """The gather pass of ``csrc/edge_head.cu`` in torch, given ``P = x @
    W_all``: window sums over t ascending, merge sums over j ascending."""
    B, N, _ = P.shape
    hk = k // 2
    il = idx.long()

    def nbr(col0, width, j):                       # P[idx[:, :, j], cols]
        seg = P[..., col0:col0 + width]
        return torch.gather(seg, 1, il[:, :, j, None].expand(B, N, width))

    ca = window * four_fin
    we = (window + 1) * four_fin
    am = we + k * two_f
    point = P[..., ca:ca + four_fin] + pb_point[:, None, :]
    parts = []
    for wp in range(hk):
        y = point
        for t in range(window):
            y = y + nbr(t * four_fin, four_fin, wp + t)
        parts.append(y)
    inte = torch.cat(parts, dim=-1)
    partial = P[..., am:am + two_f]
    for j in range(k):
        partial = partial + nbr(we + j * two_f, two_f, j)
    partial = partial + pb_merge[:, None, :]
    inte4 = inte.reshape(B, N, hk, four_fin)
    stats = torch.stack([inte4.sum(dim=(0, 1, 2)),
                         (inte4 * inte4).sum(dim=(0, 1, 2))])
    if pcat is None:
        return inte, partial, stats, None, None, None
    rows = []
    for s in range(k):
        j = (s % 2) * hk + s // 2
        rows.append(torch.gather(pcat, 1, il[:, :, j, None].expand(
            B, N, PROJ)) + ppoint)
    wrow = torch.stack(rows, dim=2)                # (B, N, k, 32)
    half = PROJ // 2
    wstats = torch.stack([wrow.sum(dim=(0, 1)).reshape(k * PROJ),
                          (wrow * wrow).sum(dim=(0, 1)).reshape(k * PROJ)])
    return (inte, partial, stats, wrow[..., :half].reshape(B, N, k * half),
            wrow[..., half:].reshape(B, N, k * half), wstats)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_products_before_the_gather_reproduce_the_head(stage, gated):
    _, c, cx, four_fin, two_f = STAGES[stage]
    B, N, k = 2, 64, K
    window = k // 2 + 1
    cf = c + cx
    rng = np.random.RandomState(10 * stage + gated)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    x = r(B, N, c)
    xs = r(B, cx) if cx else None
    ops = head_operands(x, r(1, window, 2 * cf, four_fin,
                             scale=(2 * cf * window) ** -0.5),
                        r(four_fin, scale=0.1),
                        r(2 * k * 2 * cf, two_f, scale=(4 * k * cf) ** -0.5),
                        k, xs)
    _, wn, ca, pb, am, wen, pbm, window = ops
    pcat = r(B, N, PROJ) if gated else None
    ppoint = r(B, N, PROJ) if gated else None
    # neighbours with repeats: every row names some point two or three times
    idx = rng.randint(0, N, size=(B, N, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    idx[:, ::2, k - 1] = idx[:, ::2, 0]
    idx_t = torch.from_numpy(idx)

    w_all = pack_head_weights(wn, ca, am, wen, k, window)
    assert w_all.shape == (c, (window + 1) * four_fin + (k + 1) * two_f)
    got = gather_sums(x @ w_all, idx_t, pb, pbm, pcat, ppoint, k, window,
                      four_fin, two_f)
    want = head_reference_given_idx(x, wn, ca, pb, am, wen, pbm, pcat,
                                    ppoint, idx_t, k, window)
    j = (lambda v: None if v is None else jnp.asarray(v.numpy()))
    want_j = _head_reference_given_idx(
        j(x), j(wn), j(ca), j(pb), j(am), j(wen), j(pbm), j(pcat),
        j(ppoint), jnp.asarray(idx), k, window)
    names = ("inte", "partial", "stats", "wfea", "wxyz", "wstats")
    for name, g, w, wj in zip(names, got, want, want_j):
        if not gated and name in ("wfea", "wxyz", "wstats"):
            assert g is None and w is None and wj is None
            continue
        assert rel(g, w) <= 1e-5, name
        assert rel(g, np.asarray(wj)) <= 1e-5, name
