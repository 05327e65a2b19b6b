"""The head backward's decomposition, on the CPU.

``csrc/edge_head_bwd.cu`` gathers the window conv's cotangents onto their
rows before it multiplies, the transpose of the forward's ``x[idx] W =
(x W)[idx]``: with ``dy[p, wp] = d_inte + ds0 + 2 inte ds1``,

    A_t[q] = sum over the entries (p, j) naming q, t <= j < t + hk, of
             dy[p, j - t]                                   (t < window)
    S[q]   = sum_wp dy[q, wp]
    d_x    = [A_0 | .. | S] W_conv + dm[q, k] + sum of dm[p, j] over the
             entries,  dm = d_partial W_merge
    d_W    = x^T [A_0 | .. | S];  d_[wen; a_merge] = gathered x^T d_partial

``gathered_head_bwd`` writes those steps in torch with the wrapper's own
packing (``pack_head_bwd_weights``, ``unpack_head_bwd_grads``, widths
padded to multiples of 4). It holds them against the plain backward
(autograd's VJP of ``head_reference_given_idx``) and against ``jax.vjp`` of
the JAX package's ``_head_reference_given_idx`` on the same numpy inputs:
rel <= 1e-5 (fp32 sums regrouped), gated and plain, k in {2, 10, 14}, on
graphs full of hub rows and repeated indices, at widths that are and are
not multiples of 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel

from pdgn_tpu.ops.pallas.edge_head import _head_reference_given_idx
from pdgn_tpu_torch.ops.kernels.edge_head import (PROJ, head_bwd_plain,
                                                  head_reference_given_idx,
                                                  pack_head_bwd_weights,
                                                  unpack_head_bwd_grads)

NAMES = ("x", "wn_flat", "conv_a", "pb_point", "a_merge", "wen", "pb_merge")


def gathered_head_bwd(x, idx, inte, wn, ca, am, wen, cts, k, window):
    """Steps 2-6 of ``csrc/edge_head_bwd.cu`` in torch: the cotangents
    summed onto their rows over the reverse adjacency (entries ascending),
    then one product of each kind. Returns the gradients of ``x, wn_flat,
    conv_a, pb_point, a_merge, wen, pb_merge``."""
    B, N, C = x.shape
    hk = k // 2
    four_fin, two_f = ca.shape[-1], am.shape[-1]
    c4, ldf, t4 = (-(-v // 4) * 4 for v in (C, four_fin, two_f))
    rows = B * N
    pad = torch.nn.functional.pad
    d_inte, d_partial, d_stats = cts[:3]
    dy = (d_inte.reshape(rows, hk, four_fin) + d_stats[0]
          + 2 * inte.reshape(rows, hk, four_fin) * d_stats[1])
    # entry e = p*k + j names the row q = b*N + idx[p, j]
    q_of = (idx.long() + N * torch.arange(B)[:, None, None]).reshape(-1)
    ent = torch.arange(rows * k)
    p_of, j_of = ent // k, ent % k
    blocks = []
    for t in range(window):
        keep = (j_of >= t) & (j_of < t + hk)
        a_t = torch.zeros(rows, four_fin).index_add_(
            0, q_of[keep], dy[p_of[keep], j_of[keep] - t])
        blocks.append(pad(a_t, (0, ldf - four_fin)))
    s = dy.sum(1)
    blocks.append(pad(s, (0, ldf - four_fin)))
    gc = torch.cat(blocks, -1)                 # (rows, (window+1)*ldf)

    w_conv, w_merge = pack_head_bwd_weights(wn, ca, am, wen, k, window)
    dpart = pad(d_partial.reshape(rows, two_f), (0, t4 - two_f))
    dm = (dpart @ w_merge).reshape(rows, k + 1, c4)
    dxm = dm[:, k].index_add(0, q_of, dm[p_of, j_of])
    d_x = (gc @ w_conv + dxm)[:, :C].reshape(B, N, C)
    xp = pad(x.reshape(rows, C), (0, c4 - C))
    nbr = torch.cat([xp[q_of].reshape(rows, k, c4), xp[:, None]], 1)
    d_wn, d_ca, d_am, d_wen = unpack_head_bwd_grads(
        xp.T @ gc, nbr.reshape(rows, (k + 1) * c4).T @ dpart, C, four_fin,
        two_f, k, window)
    return (d_x, d_wn, d_ca, s.reshape(B, N, four_fin).sum(1), d_am, d_wen,
            d_partial.sum(1))


def hub_graph(rng, B, N, k):
    """Neighbour tables full of hub rows (rows 0 and 1 named by about half
    the entries) and of indices repeated within a row."""
    idx = rng.randint(0, N, size=(B, N, k))
    hub = rng.rand(B, N, k) < 0.5
    idx[hub] = rng.randint(0, 2, size=int(hub.sum()))
    idx[:, ::3, k - 1] = idx[:, ::3, 0]
    if k > 2:
        idx[:, 1::2, 1] = idx[:, 1::2, 2]
    return idx.astype(np.int32)


@pytest.mark.parametrize("C,four_fin,two_f", [(16, 64, 32), (6, 10, 6)])
@pytest.mark.parametrize("k", [2, 10, 14])
@pytest.mark.parametrize("gated", [False, True])
def test_gathered_cotangents_reproduce_the_head_vjp(gated, k, C, four_fin,
                                                    two_f):
    B, N = 2, 40
    hk = k // 2
    window = hk + 1
    rng = np.random.RandomState(100 * k + 10 * gated + C)
    f = np.float32

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(f)

    x = r(B, N, C, scale=0.5)
    wn = r(window * C, four_fin, scale=0.1)
    ca = r(C, four_fin, scale=0.1)
    pb = r(B, four_fin, scale=0.1)
    am = r(C, two_f, scale=0.1)
    wen = r(k * C, two_f, scale=0.05)
    pbm = r(B, two_f, scale=0.1)
    pcat = r(B, N, PROJ, scale=0.5) if gated else None
    ppoint = r(B, N, PROJ, scale=0.5) if gated else None
    idx = hub_graph(rng, B, N, k)
    cts = [r(B, N, hk * four_fin), r(B, N, two_f), r(2, four_fin, scale=0.01)]
    if gated:
        cts += [r(B, N, k * 16), r(B, N, k * 16), r(2, k * 32, scale=0.01)]

    tt = (lambda v: None if v is None else torch.from_numpy(v))
    ins = [tt(v) for v in (x, wn, ca, pb, am, wen, pbm, pcat, ppoint)]
    idx_t = torch.from_numpy(idx)
    cts_t = [torch.from_numpy(c) for c in cts]
    inte = head_reference_given_idx(*ins, idx_t, k, window)[0]

    got = gathered_head_bwd(ins[0], idx_t, inte, ins[1], ins[2], ins[4],
                            ins[5], cts_t, k, window)
    plain = head_bwd_plain(ins[0], idx_t, *ins[1:], cts_t, k, window)

    live = [jnp.asarray(v) for v in (x, wn, ca, pb, am, wen, pbm)]
    extra = [jnp.asarray(v) for v in (pcat, ppoint)] if gated else []

    def jf(*args):
        g = args[7:] if gated else (None, None)
        out = _head_reference_given_idx(*args[:7], *g, jnp.asarray(idx), k,
                                        window)
        return [o for o in out if o is not None]

    _, vjp = jax.vjp(jf, *live, *extra)
    want_j = vjp([jnp.asarray(c) for c in cts])

    for name, g, w, wj in zip(NAMES, got, plain, want_j):
        assert g.shape == w.shape, name
        assert rel(g, w) <= 1e-5, (name, rel(g, w))
        assert rel(g, np.asarray(wj)) <= 1e-5, (name, rel(g, np.asarray(wj)))
