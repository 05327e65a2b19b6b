"""The bf16 head backward's decomposition on the card (``csrc/edge_head_bwd.cu``,
``pdgn_edge_head_bwd_bf16``), transcribed in torch over the wrapper's own
packing, before the card runs it:

* the dy pass: ``dy_b`` (rows, hk, ld8) rounded once, ``S`` in fp32 and
  rounded once (``sb``), the gathered x blocks ``xg[q] = [x[nbr[q, 0]] | ..
  | x[nbr[q, k-1]] | x[q]]``, and ``dxm``;
* ``d_x``: per row the sums over its reverse-adjacency list (ascending
  entries) of ``dy_b[p, j - t]``, split into two bf16 parts, against
  ``pack_head_bwd_weights_bf16``'s ``w_dx`` blocks (tap t at columns ``t *
  ldk``, conv_a last), ``S_b`` against conv_a, ``dxm`` added, rounded once;
* the weight gradients as ``product_bf16_kernel`` forms them: ``d_wn[t] =
  sum over (p, wp) of x[nbr[p, wp + t]]^T dy_b[p, wp]`` (the TPU kernel's
  patch^T dy_b) from ``xg``'s block ``wp + t``, ``d_conv_a`` from block k
  and ``sb``, ``d_[wen; a_merge]`` from blocks 0..k and ``dpart_b``, each
  split over the rows in ``head_bwd_splits_bf16``'s ranges (stage ``s =
  w * blocks + row block``), the partials added in split order in float64
  (``column_reduce``), then cut back by ``unpack_head_bwd_grads_bf16``.

It is held against ``head_bwd_plain_bf16`` (the card's reference): fp32
gradients rel <= 1e-4, bf16 ones within 2 ulps (``bf16_ulps``, the card
tests' limit); and against JAX's ``_head_bwd_pallas(..., interpret=True)``
on the same numpy inputs at the limits ``test_torch_bf16_train_kernels``
states for the plain version (``d_x`` 64 ulps and rel 1e-2, other bf16
outputs 1 ulp, fp32 rel 1e-5). Graphs with hub rows (half the entries name
one of three rows) and repeated indices, k in {2, 10, 14}, C and 4Fin off
multiples of 8. A packing fault (a tap's block out of place, the S block
misplaced, a pad in the wrong place) moves whole blocks and fails here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (bf16_pair, bf16_ulps, one_torch_thread,  # noqa: F401
                             rel)

from pdgn_tpu.ops.pallas.edge_head import _head_bwd_pallas
from pdgn_tpu_torch.models.layers import round_bf16
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.edge_head import (
    BWD_DX_CHUNK, head_bwd_plain_bf16, head_bwd_rows_per_block,
    head_bwd_splits_bf16, head_reference_given_idx, pack_head_bwd_weights_bf16,
    unpack_head_bwd_grads_bf16)

BF = torch.bfloat16
F = np.float32
T = torch.from_numpy
J = jnp.asarray
SMS = 132          # the H100's SMs: the splits' boundaries on that card
NAMES = ("d_x", "d_wn", "d_conv_a", "d_pb_point", "d_a_merge", "d_wen",
         "d_pb_merge", "d_pcat", "d_ppoint")


def _graph(rng, B, N, k, hubs):
    """k neighbours a point, itself excluded; with ``hubs``, half of each
    row's slots name one of three hub rows and one slot repeats another."""
    idx = np.stack([np.stack([
        rng.choice(np.delete(np.arange(N), n), k, replace=False)
        for n in range(N)]) for _ in range(B)])
    if hubs:
        hub = rng.randint(0, 3, size=(B, N, k // 2))
        idx[:, :, : k // 2] = np.where(
            hub == np.arange(N)[None, :, None], (hub + 1) % 3, hub)
        if k > 2:
            idx[:, :, -1] = idx[:, :, -2]
    return idx.astype(np.int32)


def _case(seed, B, N, C, k, four_fin, two_f, gated, hubs):
    """bf16 x, fp32 weights (rounded inside, as the head's autograd
    Function hands them on), the forward's own inte, and cotangents as bf16
    training gives them; each as (torch, jax)."""
    rng = np.random.RandomState(seed)
    hk, window = k // 2, k // 2 + 1
    x = bf16_pair(rng.randn(B, N, C) * 0.5)
    idx = _graph(rng, B, N, k, hubs)
    w = dict(wn=(rng.randn(window * C, four_fin) * 0.1).astype(F),
             ca=(rng.randn(C, four_fin) * 0.1).astype(F),
             pb=(rng.randn(B, four_fin) * 0.1).astype(F),
             am=(rng.randn(C, two_f) * 0.05).astype(F),
             wen=(rng.randn(k * C, two_f) * 0.05).astype(F),
             pbm=(rng.randn(B, two_f) * 0.1).astype(F))
    pc = ([bf16_pair(rng.randn(B, N, 32) * 0.5) for _ in range(2)]
          if gated else [(None, None)] * 2)
    inte = head_reference_given_idx(
        x[0], *(T(w[n]).to(BF) for n in ("wn", "ca")), T(w["pb"]),
        *(T(w[n]).to(BF) for n in ("am", "wen")), T(w["pbm"]), pc[0][0],
        pc[1][0], T(idx), k, window)[0]
    inte = (inte, J(inte.float().numpy()).astype(jnp.bfloat16))
    d_partial = T((rng.randn(B, N, two_f) * 0.1).astype(F)).to(BF).float()
    ds = T((rng.randn(2, four_fin) * 0.01).astype(F))
    cts = [bf16_pair(rng.randn(B, N, hk * four_fin) * 0.1),
           (d_partial, J(d_partial.numpy())), (ds, J(ds.numpy()))]
    if gated:
        dws = T((rng.randn(2, k * 32) * 0.01).astype(F))
        cts += [bf16_pair(rng.randn(B, N, k * 16) * 0.1),
                bf16_pair(rng.randn(B, N, k * 16) * 0.1),
                (dws, J(dws.numpy()))]
    else:
        cts += [(None, None)] * 3
    return x, idx, w, pc, inte, cts


def _split_sum(stage, stages, splits):
    """``sum_s stage(s)`` as ``product_bf16_kernel`` and ``column_reduce``
    form it: split z's partial over its stages ``[z * stages // splits,
    (z + 1) * stages // splits)`` in fp32, the partials added in split order
    in float64, rounded to fp32."""
    total = None
    for z in range(splits):
        part = None
        for s in range(z * stages // splits, (z + 1) * stages // splits):
            v = stage(s)
            part = v if part is None else part + v
        if part is None:
            continue
        total = part.double() if total is None else total + part.double()
    return total.float()


def decomposed(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts, k):
    """The bf16 backward in the card's decomposition, over the wrapper's
    packing (module docstring); same returns as ``head_bwd_kernel``."""
    B, N, C = x.shape
    hk, window = k // 2, k // 2 + 1
    four_fin, two_f = ca.shape[-1], am.shape[-1]
    rows = B * N
    c8, ld8, t8 = _lib.up8(C), _lib.up8(four_fin), _lib.up8(two_f)
    ldk = -(-four_fin // BWD_DX_CHUNK) * BWD_DX_CHUNK
    pad = torch.nn.functional.pad
    w_dx, w_dm = (w.float() for w in pack_head_bwd_weights_bf16(
        wn, ca, am, wen, k, window))
    d_inte, d_partial, d_stats = cts[0].float(), cts[1].float(), cts[2]
    nbr = (idx.long() + N * torch.arange(B)[:, None, None]).reshape(rows, k)

    # the dy pass
    dy = ((d_inte.reshape(rows, hk, four_fin) + d_stats[0])
          + (2.0 * inte.float().reshape(rows, hk, four_fin)) * d_stats[1])
    S = dy[:, 0]
    for wp in range(1, hk):
        S = S + dy[:, wp]
    dyb = pad(round_bf16(dy), (0, ld8 - four_fin))        # (rows, hk, ld8)
    sb = pad(round_bf16(S), (0, ld8 - four_fin))
    xp = pad(x.float().reshape(rows, C), (0, c8 - C))
    xg = torch.cat([xp[nbr], xp[:, None]], dim=1)          # (rows, k+1, c8)
    dpart_b = pad(round_bf16(d_partial.reshape(rows, two_f)),
                  (0, t8 - two_f))
    dm = (dpart_b @ w_dm.T).reshape(rows, k + 1, c8)
    dxm = dm[:, k].index_add(0, nbr.reshape(-1), dm[:, :k].reshape(-1, c8))

    # d_x: A_t summed over the rows' lists in ascending entry order (the
    # order in which index_add_ visits its sources here), split in two
    # bf16 parts; depth column t*ldk + f of w_dx meets A_t[:, f]
    acc = torch.zeros(rows, c8)
    for t in range(window + 1):
        wt = w_dx[:, t * ldk:t * ldk + ld8]
        if t == window:
            acc = acc + sb @ wt.T
            continue
        a = torch.zeros(rows, ld8).index_add_(
            0, nbr[:, t:t + hk].reshape(-1), dyb.reshape(-1, ld8))
        a_hi = round_bf16(a)
        acc = acc + a_hi @ wt.T + round_bf16(a - a_hi) @ wt.T
    assert not w_dx.reshape(c8, window + 1, ldk)[:, :, four_fin:].any()
    d_x = (dxm + acc).to(BF)[:, :C].reshape(B, N, C)

    # the weight gradients, split over the rows as the card splits them
    splits = head_bwd_splits_bf16(rows, C, four_fin, two_f, k, SMS)
    blocks = -(-rows // 64)

    def rows_of(s):
        return slice((s % blocks) * 64, (s % blocks + 1) * 64)

    def d_wn_stage(s):
        w, r = s // blocks, rows_of(s)
        return torch.cat([xg[r, w + t].T @ dyb[r, w] for t in range(window)])

    d_wn = _split_sum(d_wn_stage, hk * blocks, splits[0])
    d_ca = _split_sum(lambda s: xg[rows_of(s), k].T @ sb[rows_of(s)],
                      blocks, splits[1])
    d_wm = _split_sum(lambda s: torch.cat([
        xg[rows_of(s), j].T @ dpart_b[rows_of(s)] for j in range(k + 1)]),
        blocks, splits[2])
    d_wn, d_ca, d_am, d_wen = unpack_head_bwd_grads_bf16(
        d_wn, d_ca, d_wm, C, four_fin, two_f, k, window)
    # the bias gradient: S summed over rpb rows a block, in row order, then
    # the blocks' partials in order
    rpb = head_bwd_rows_per_block(N, ld8)
    rows_of_block = S.reshape(B, N // rpb, rpb, four_fin)
    part = rows_of_block[:, :, 0]
    for r in range(1, rpb):
        part = part + rows_of_block[:, :, r]
    d_pb = part[:, 0]
    for blk in range(1, N // rpb):
        d_pb = d_pb + part[:, blk]
    d_pbm = d_partial.reshape(B, N, two_f).sum(dim=1)
    out = (d_x, d_wn, d_ca, d_pb, d_am, d_wen, d_pbm)
    if pcat is None:
        return out + (None, None)
    # the weight-net gathers are the parent's kernels, as the plain version
    plain = head_bwd_plain_bf16(x, idx, inte, wn, ca, am, wen, pcat, ppoint,
                                cts, k, window)
    return out + plain[7:]


def _port(fn, x, idx, w, pc, inte, cts, k):
    args = (x[0], T(idx), inte[0], T(w["wn"]).to(BF), T(w["ca"]).to(BF),
            T(w["am"]).to(BF), T(w["wen"]).to(BF), pc[0][0], pc[1][0],
            [c[0] for c in cts], k)
    return fn(*args) if fn is decomposed else fn(*args, k // 2 + 1)


@pytest.mark.parametrize("k,C,four_fin,two_f,gated,hubs", [
    (2, 16, 24, 16, True, False),
    (10, 36, 130, 66, True, True),      # C, 4Fin, 2F off multiples of 8
    (10, 24, 136, 40, False, True),
    (14, 12, 40, 24, True, True)])
def test_decomposition_matches_plain(k, C, four_fin, two_f, gated, hubs):
    """The transcription against ``head_bwd_plain_bf16``: fp32 gradients rel
    <= 1e-4, bf16 ones within 2 ulps."""
    case = _case(k + C, 2, 72, C, k, four_fin, two_f, gated, hubs)
    got = _port(decomposed, *case, k)
    want = _port(head_bwd_plain_bf16, *case, k)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == BF:
            assert bf16_ulps(g, w) <= 2.0, (name, bf16_ulps(g, w))
        else:
            assert rel(g, w) <= 1e-4, (name, rel(g, w))


def test_decomposition_matches_the_interpret_kernel():
    """The transcription against ``_head_bwd_pallas(..., interpret=True)``
    at the plain version's limits (``test_torch_bf16_train_kernels``)."""
    k, C, four_fin, two_f = 6, 16, 16, 16
    x, idx, w, pc, inte, cts = _case(0, 2, 128, C, k, four_fin, two_f, True,
                                     True)
    want = _head_bwd_pallas(
        x[1], J(w["wn"]), J(w["ca"]), J(w["am"]), J(w["wen"]), pc[0][1],
        pc[1][1], J(idx), inte[1], *(c[1] for c in cts), k, k // 2 + 1,
        True)
    got = _port(decomposed, x, idx, w, pc, inte, cts, k)
    for name, g, wv in zip(NAMES, got, want):
        wv = np.asarray(wv, np.float32).reshape(tuple(g.shape))
        if g.dtype == BF:
            ulps, frac = (64.0, 1e-2) if name == "d_x" else (1.0, 1e-2)
            assert bf16_ulps(g, wv) <= ulps, (name, bf16_ulps(g, wv))
            assert rel(g.float(), wv) <= frac, (name, rel(g.float(), wv))
        else:
            assert rel(g, wv) <= 1e-5, (name, rel(g, wv))
