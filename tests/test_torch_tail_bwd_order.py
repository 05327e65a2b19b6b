"""The tail backward's launch order, on the CPU.

``csrc/bilateral_tail_bwd.cu`` runs the VJP of the stage tail in this order,
every product on the shared 3xTF32 core:

    1. dg = dy wi^T                     (it needs no g)
    2. the gate pass: the slot logits v = h_s w2k + w2b recomputed once,
       the softmax's weights w, then g = LeakyReLU(inte*isc + ish) w (for
       d_wi), d_inte, dv and the seven channel sums; where v*s2 + t2 lies
       within the tensor cores' error bound of LeakyReLU's kink, its branch
       goes by the sign recomputed in float64
    3. d_h = dv w2k^T, d_w2k = h^T dv, d_wi = g^T dy

with the wrapper's padding: dy and wi^T to t4 = 2F rounded up to 4, wi^T, g
and dg to ldg = k/2*4Fin rounded up, dv to ldv = 2Fin rounded up (its pad
columns zero), w2k^T to ldv zero rows, the padded rows of d_wi cut.
``ordered_tail_bwd`` writes those steps in torch. It is held against
``jax.vjp`` of the JAX package's tail reference (``_reference``, the body
the Pallas kernels' VJP differentiates) on the same numpy inputs, softmax
on, at k in {4, 10, 18} (18: the gate pass's chunked two-pass route) and
at 4Fin = 130 (2Fin = 65 odd, 2F = 66: every width padded), gated and
plain: rel <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import rel

from pdgn_tpu.ops.pallas.bilateral_tail import _reference as jax_reference
from pdgn_tpu_torch.ops.kernels.bilateral_tail import KINK_BOUND

pad = torch.nn.functional.pad


def up4(v: int) -> int:
    return -(-v // 4) * 4


def leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def leaky_grad(pre, d):
    return torch.where(pre > 0, d, 0.01 * d)


def ordered_tail_bwd(inte, h, isc, ish, w2k, w2b, s2, t2, wi, dy, k):
    """Steps 1-3 of the CUDA backward in torch (softmax on). Returns the
    gradients of ``inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias`` (None for
    h..t2 on the plain stage) and g."""
    B, N, two_f = dy.shape
    rows, hk = B * N, k // 2
    four_fin = inte.shape[-1] // hk
    two_fin, K = four_fin // 2, inte.shape[-1]
    ldg, t4, ldv = up4(K), up4(two_f), up4(two_fin)
    dy_p = pad(dy.reshape(rows, two_f), (0, t4 - two_f))
    wi_t = pad(wi.T, (0, ldg - K, 0, t4 - two_f))
    # 1. dg, and d_bias
    dg = dy_p @ wi_t                                    # (rows, ldg)
    d_bias = dy_p[:, :two_f].sum(0)
    # 2. the gate pass: slot s, channel c at column s*2Fin + c, which is
    #    block channel (s % 2)*2Fin + c
    par = torch.arange(k) % 2
    x = inte.reshape(rows, k, two_fin)
    dgs = dg[:, :K].reshape(rows, k, two_fin)
    a = isc.reshape(2, two_fin)[par]
    gpre = x * a + ish.reshape(2, two_fin)[par]
    lg = leaky(gpre)
    w = torch.ones(())
    if h is not None:
        hs = h.reshape(rows * k, 64)
        v = (hs @ w2k).reshape(rows, k, two_fin) + w2b
        upre = v * s2 + t2
        u = leaky(upre)
        e = torch.exp(u - u.max(1, keepdim=True).values)
        z = e.sum(1, keepdim=True)
        w = e * (1 / z) if k <= 16 else e / z
    g = lg * w
    dgpre = leaky_grad(gpre, dgs * w)
    d_inte = (dgpre * a).reshape(inte.shape)

    def by_parity(t):                                   # -> (4Fin,)
        return torch.stack([t[:, 0::2].sum((0, 1)), t[:, 1::2].sum((0, 1))])

    d_isc = by_parity(dgpre * x).reshape(four_fin)
    d_ish = by_parity(dgpre).reshape(four_fin)
    grads = [None] * 5
    if h is not None:
        du = dgs * lg
        da = w * (du - (w * du).sum(1, keepdim=True))
        # within the tensor cores' error bound of the kink (the wrapper's
        # KINK_BOUND), the branch by the sign of v*s2 + t2 in float64
        kink = s2.abs() * (w2k.abs().sum(0) * h.abs().max() + w2b.abs()) \
            * KINK_BOUND
        v64 = (hs.double() @ w2k.double()).reshape(rows, k, two_fin) \
            + w2b.double()
        exact = (v64 * s2.double() + t2.double() > 0).float() * 2 - 1
        upre = torch.where(upre.abs() <= kink, exact, upre)
        dpre = leaky_grad(upre, da)
        dv = dpre * s2
        dv_p = pad(dv.reshape(rows * k, two_fin), (0, ldv - two_fin))
        # 3. conv_all2's backward
        w2k_t = pad(w2k.T, (0, 0, 0, ldv - two_fin))
        d_h = (dv_p @ w2k_t).reshape(h.shape)
        d_w2k = hs.T @ dv_p[:, :two_fin]
        grads = [d_h, d_w2k, dv.sum((0, 1)), (dpre * v).sum((0, 1)),
                 dpre.sum((0, 1))]
    g_p = pad(g.reshape(rows, K), (0, ldg - K))
    d_wi = (g_p.T @ dy_p)[:K, :two_f]
    d_h, d_w2k, d_w2b, d_s2, d_t2 = grads
    return (d_inte, d_h, d_isc, d_ish, d_w2k, d_w2b, d_s2, d_t2, d_wi,
            d_bias), g.reshape(rows, K)


@pytest.mark.parametrize("gated,k,four_fin,two_f", [(True, 4, 32, 24),
                                                    (True, 10, 64, 32),
                                                    (True, 18, 32, 16),
                                                    (True, 10, 130, 66),
                                                    (False, 10, 130, 66)])
def test_ordered_backward_matches_jax_vjp(gated, k, four_fin, two_f):
    rng = np.random.RandomState(k + two_f + 100 * gated)
    B, N, hk = 2, 21, k // 2
    two_fin = four_fin // 2

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.randn(*shape) * scale + shift).astype(np.float32)

    ins = [r(B, N, two_f), r(B, N, hk * four_fin),
           r(B, N, k * 64, scale=0.5) if gated else None,
           r(four_fin, scale=0.2, shift=1.0), r(four_fin, scale=0.1),
           r(64, two_fin, scale=0.125) if gated else None,
           r(two_fin, scale=0.1) if gated else None,
           r(two_fin, scale=0.2, shift=1.0) if gated else None,
           r(two_fin, scale=0.1) if gated else None,
           r(hk * four_fin, two_f, scale=(hk * four_fin) ** -0.5),
           r(two_f, scale=0.1)]
    dy = r(B, N, two_f)
    live = [i for i, v in enumerate(ins) if v is not None]

    def f(*vals):
        full = [None] * len(ins)
        for i, v in zip(live, vals):
            full[i] = v
        return jax_reference(*full, k, True)

    _, vjp = jax.vjp(f, *[jnp.asarray(ins[i]) for i in live])
    want = dict(zip(live, vjp(jnp.asarray(dy))))
    t = [None if v is None else torch.from_numpy(v) for v in ins]
    got, g = ordered_tail_bwd(*t[1:10], torch.from_numpy(dy), k)
    names = ("inte", "h", "isc", "ish", "w2k", "w2b", "s2", "t2", "wi",
             "bias")
    for i, (name, a) in enumerate(zip(names, got), start=1):
        if i not in want:
            assert a is None, name
            continue
        assert rel(a, np.asarray(want[i])) <= 1e-5, (name, rel(a, want[i]))
    # g for d_wi is the forward's gate
    rows = B * N
    gi = torch.from_numpy(ins[1]).reshape(rows, hk, four_fin)
    g_fwd = leaky(gi * t[3] + t[4])
    if gated:
        hh = t[2].reshape(rows, k, 64)
        u = torch.softmax(leaky((hh @ t[5] + t[6]) * t[7] + t[8]), dim=1)
        g_fwd = g_fwd * u.reshape(rows, hk, four_fin)
    assert rel(g, g_fwd.reshape(rows, -1)) <= 1e-6
