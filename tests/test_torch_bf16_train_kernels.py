"""The bf16 backwards' plain versions (the CPU path of ``--phase train
--compute_dtype bfloat16``) against the JAX package's TPU kernels run in
interpret mode on the same bf16 inputs, the same graph and the same
cotangents; and, at looser bounds, against ``jax.vjp`` of the jnp
reference bodies, which is what the JAX package differentiates on the CPU.

Two references, and the port follows the kernel. The TPU kernels
(``_head_bwd_kernel``, ``_gated_bwd_kernel``, ``_plain_bwd_kernel``) round
their product operands to bf16 and keep every cotangent in fp32; ``jax.vjp``
of the reference bodies rounds the cotangent of every bf16 value it
passes (the gate's slot weights, the window outputs), which the kernels
never form. The port's bf16 instances and their plain versions take the
kernels' rounding points. The head's gathered design adds one difference
(``csrc/edge_head_bwd.cu``): the kernel rounds each entry's neighbour
cotangent ``dnbr`` before it scatters it, the port sums the entries'
window cotangents onto their rows first and keeps that sum unrounded
(two bf16 parts), so ``d_x`` differs from the kernel by the kernel's own
``dnbr`` roundings.

Cases: B=2, N=128 (the kernels' tile), k=6, H=64, 4Fin=16, 2F=16; inputs
drawn with numpy, ``inte`` the head forward's own (so that the reference's
recomputed statistics cotangent is the kernel's). Tolerances, measured
here over seeds 0-2, gated and plain:

* the head against the interpret kernel: ``d_x`` within 41.1 bf16 ulps of
  the larger magnitude, counted at no less than 1/256 of the largest
  (``bf16_ulps``), rel 6.0e-3 of its largest; limits 64 ulps, rel 1e-2.
  ``d_pcat``/``d_ppoint`` bit-equal (limit 1 ulp); the weight and bias
  gradients rel <= 1.5e-6 (limit 1e-5). At those limits ``d_x`` does not
  see the rounding of each window's ``dy``: a plain version without it
  still passed ``d_x`` and failed ``d_wn`` at rel 1.2-1.5e-3, which reads
  the same operand. That rounding is checked through ``d_wn`` and
  ``d_conv_a``; ``d_x`` catches the low bf16 part of A dropped (78 ulps,
  gated) and the statistics fold without its variance term (446-462
  ulps).
* the tails against the interpret kernels: ``d_inte`` 1 ulp, ``d_h`` 1.5
  (limit 2); fp32 outputs rel <= 1.3e-5 (one ``dpre`` rounding the other
  way; limit 1e-4).
* against ``jax.vjp`` of the references, rel of each output's largest:
  the head's ``d_x`` 1.0e-2, its weight gradients <= 4.8e-3, ``d_pcat``
  7.3e-3, ``d_ppoint`` 3.9e-3; the tails' outputs <= 6.8e-3. The limits
  (``HEAD_REF``, ``TAIL_REF``) are about twice those.
* slot stats' backward against JAX's ``_bwd``: bit-equal (limit 1 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (bf16_pair, bf16_ulps, one_torch_thread,  # noqa: F401
                             rel)

from pdgn_tpu.ops.pallas import slot_stats as jslot
from pdgn_tpu.ops.pallas.bilateral_tail import _bwd_pallas, _reference
from pdgn_tpu.ops.pallas.edge_head import (_head_bwd_pallas,
                                           _head_reference_given_idx)
from pdgn_tpu_torch.ops.kernels import _lib
from pdgn_tpu_torch.ops.kernels.bilateral_tail import (edge_conv_tail,
                                                       tail_bwd_plain_bf16)
from pdgn_tpu_torch.ops.kernels.edge_head import (edge_conv_head,
                                                  head_bwd_plain_bf16,
                                                  head_reference_given_idx)
from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                   stats_bwd)

B, N, C, K, TWO_F = 2, 128, 16, 6, 16
HK, WINDOW, FOUR_FIN = K // 2, K // 2 + 1, 16
F = np.float32
BF = torch.bfloat16
T = torch.from_numpy
J = jnp.asarray
HEAD_NAMES = ("d_x", "d_wn", "d_conv_a", "d_pb_point", "d_a_merge", "d_wen",
              "d_pb_merge", "d_pcat", "d_ppoint")
TAIL_NAMES = ("d_partial", "d_inte", "d_h", "d_isc", "d_ish", "d_w2k",
              "d_w2b", "d_s2", "d_t2", "d_wi", "d_bias")
# against jax.vjp of the reference bodies (module docstring)
HEAD_REF = dict(d_x=2e-2, d_wn=1e-2, d_conv_a=1e-2, d_pb_point=5e-3,
                d_a_merge=1e-2, d_wen=1e-2, d_pb_merge=1e-6, d_pcat=1.5e-2,
                d_ppoint=1e-2)
TAIL_REF = dict(d_partial=0.0, d_inte=1.5e-2, d_h=1.5e-2, d_isc=1.5e-2,
                d_ish=1.5e-2, d_w2k=1.5e-2, d_w2b=1.5e-2, d_s2=1.5e-2,
                d_t2=1.5e-2, d_wi=1.5e-2, d_bias=0.0)


def _vjp(f, prim, ct):
    """``jax.vjp(f, *prim)[1](ct)`` jitted with XLA's excess precision off
    (bit-equal to the eager VJP here, and seconds faster)"""
    def g(prim, ct):
        return jax.vjp(f, *prim)[1](ct)

    return jax.jit(g).lower(prim, ct).compile(
        compiler_options={"xla_allow_excess_precision": False})(prim, ct)


def _graph(rng):
    """A graph of k distinct neighbours a point, itself excluded."""
    return np.stack([np.stack([
        rng.choice(np.delete(np.arange(N), n), K, replace=False)
        for n in range(N)]) for _ in range(B)]).astype(np.int32)


def _head_case(seed, gated):
    rng = np.random.RandomState(seed)
    x = bf16_pair(rng.randn(B, N, C) * 0.5)
    idx = _graph(rng)
    w = dict(wn=(rng.randn(WINDOW * C, FOUR_FIN) * 0.1).astype(F),
             ca=(rng.randn(C, FOUR_FIN) * 0.1).astype(F),
             pb=(rng.randn(B, FOUR_FIN) * 0.1).astype(F),
             am=(rng.randn(C, TWO_F) * 0.05).astype(F),
             wen=(rng.randn(K * C, TWO_F) * 0.05).astype(F),
             pbm=(rng.randn(B, TWO_F) * 0.1).astype(F))
    pc = ([bf16_pair(rng.randn(B, N, 32) * 0.5) for _ in range(2)]
          if gated else [(None, None)] * 2)
    # inte: the forward's own, so that both references see one function
    inte = head_reference_given_idx(
        x[0], *(T(w[n]).to(BF) for n in ("wn", "ca")), T(w["pb"]),
        *(T(w[n]).to(BF) for n in ("am", "wen")), T(w["pbm"]), pc[0][0],
        pc[1][0], T(idx), K, WINDOW)[0]
    inte = (inte, J(inte.float().numpy()).astype(jnp.bfloat16))
    d_partial = T((rng.randn(B, N, TWO_F) * 0.1).astype(F)).to(BF).float()
    cts = [bf16_pair(rng.randn(B, N, HK * FOUR_FIN) * 0.1),
           (d_partial, J(d_partial.numpy())),
           (T((rng.randn(2, FOUR_FIN) * 0.01).astype(F)), None)]
    cts[2] = (cts[2][0], J(cts[2][0].numpy()))
    if gated:
        cts += [bf16_pair(rng.randn(B, N, K * 16) * 0.1),
                bf16_pair(rng.randn(B, N, K * 16) * 0.1)]
        dws = T((rng.randn(2, K * 32) * 0.01).astype(F))
        cts.append((dws, J(dws.numpy())))
    else:
        cts += [(None, None)] * 3
    return x, idx, w, pc, inte, cts


def _head_port(x, idx, w, pc, inte, cts):
    return head_bwd_plain_bf16(
        x[0], T(idx), inte[0], T(w["wn"]), T(w["ca"]), T(w["am"]),
        T(w["wen"]), pc[0][0], pc[1][0], [c[0] for c in cts], K, WINDOW)


def _check_head(got, want, name, bf16_limits, fp32_limit):
    want = np.asarray(want, np.float32).reshape(tuple(got.shape))
    if got.dtype == BF:
        ulps, frac = bf16_limits
        assert bf16_ulps(got, want) <= ulps, (name, bf16_ulps(got, want))
        assert rel(got.float(), want) <= frac, (name, rel(got.float(), want))
    else:
        assert got.dtype == torch.float32, name
        assert rel(got, want) <= fp32_limit, (name, rel(got, want))


@pytest.mark.parametrize("gated", [True, False])
def test_head_bwd_matches_the_interpret_kernel(gated):
    """``head_bwd_plain_bf16`` against ``_head_bwd_pallas(...,
    interpret=True)`` (module docstring's limits)."""
    for seed in (0,):
        x, idx, w, pc, inte, cts = _head_case(seed, gated)
        want = _head_bwd_pallas(
            x[1], J(w["wn"]), J(w["ca"]), J(w["am"]), J(w["wen"]), pc[0][1],
            pc[1][1], J(idx), inte[1], *(c[1] for c in cts), K, WINDOW,
            True)
        got = _head_port(x, idx, w, pc, inte, cts)
        assert got[0].dtype == BF and want[0].dtype == jnp.bfloat16
        for name, g, wv in zip(HEAD_NAMES, got, want):
            if wv is None:
                assert g is None and not gated
                continue
            limits = (64.0, 1e-2) if name == "d_x" else (1.0, 1e-2)
            _check_head(g, wv, name, limits, 1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_head_bwd_against_the_reference_vjp(gated):
    """The same against ``jax.vjp`` of ``_head_reference_given_idx`` (the
    JAX package's CPU path), rel of each output's largest: ``HEAD_REF``."""
    x, idx, w, pc, inte, cts = _head_case(2, gated)

    def f(*args):
        body = args[:7] + (args[7:] if gated else (None, None))
        out = _head_reference_given_idx(*body, J(idx), K, WINDOW)
        return tuple(o for o in out if o is not None)

    prim = (x[1], J(w["wn"]), J(w["ca"]), J(w["pb"]), J(w["am"]),
            J(w["wen"]), J(w["pbm"])) + ((pc[0][1], pc[1][1]) if gated
                                         else ())
    ref = _vjp(f, prim, tuple(c[1] for c in cts if c[1] is not None))
    got = _head_port(x, idx, w, pc, inte, cts)
    for name, g, r in zip(HEAD_NAMES, got, ref + (None, None)):
        if g is None:
            continue
        r = np.asarray(r, np.float32).reshape(tuple(g.shape))
        assert rel(g.float(), r) <= HEAD_REF[name], (name, rel(g.float(), r))


def _tail_case(seed):
    rng = np.random.RandomState(seed)
    fin, H = FOUR_FIN // 4, 64
    two_fin = 2 * fin
    inte = bf16_pair(rng.randn(B, N, HK * FOUR_FIN))
    h = bf16_pair(rng.randn(B, N, K * H) * 0.5)
    v = dict(isc=(rng.rand(FOUR_FIN) + 0.5).astype(F),
             ish=(rng.randn(FOUR_FIN) * 0.1).astype(F),
             w2k=(rng.randn(H, two_fin) * 0.3).astype(F),
             w2b=(rng.randn(two_fin) * 0.1).astype(F),
             s2=(rng.rand(two_fin) + 0.5).astype(F),
             t2=(rng.randn(two_fin) * 0.1).astype(F),
             wi=(rng.randn(HK * FOUR_FIN, TWO_F) * 0.05).astype(F),
             bias=(rng.randn(TWO_F) * 0.1).astype(F),
             partial=rng.randn(B, N, TWO_F).astype(F))
    dy = bf16_pair(rng.randn(B, N, TWO_F))
    return inte, h, v, dy


def _tail_port(inte, h, v, dy, gated):
    return tail_bwd_plain_bf16(
        inte[0], h[0] if gated else None,
        *(T(v[n]) for n in ("isc", "ish", "w2k", "w2b", "s2", "t2", "wi")),
        dy[0], K, True)


@pytest.mark.parametrize("gated", [True, False])
def test_tail_bwd_matches_the_interpret_kernel(gated):
    """``tail_bwd_plain_bf16`` against ``_bwd_pallas(..., interpret=True)``:
    bf16 outputs within 2 ulps, fp32 rel <= 1e-4."""
    for seed in (0,):
        inte, h, v, dy = _tail_case(seed)
        want = _bwd_pallas(
            inte[1], h[1] if gated else None,
            *(J(v[n]) for n in ("isc", "ish", "w2k", "w2b", "s2", "t2",
                                "wi")), dy[1], K, True, True)
        got = _tail_port(inte, h, v, dy, gated)
        assert torch.equal(got[0], dy[0].float())
        # _bwd_pallas: dinte, dh, disc, dish, dw2k, dw2b, ds2, dt2, dwi, dbias
        for name, g, wv in zip(TAIL_NAMES[1:], got[1:], want):
            if wv is None:
                assert g is None and not gated
                continue
            wv = np.asarray(wv, np.float32).reshape(tuple(g.shape))
            if g.dtype == BF:
                assert bf16_ulps(g, wv) <= 2.0, (name, bf16_ulps(g, wv))
            else:
                assert g.dtype == torch.float32
                assert rel(g, wv) <= 1e-4, (name, rel(g, wv))


@pytest.mark.parametrize("gated", [True, False])
def test_tail_bwd_against_the_reference_vjp(gated):
    """The same against ``jax.vjp`` of ``bilateral_tail._reference`` with
    the weights cast to bf16 as the JAX entry's CPU path passes them, rel
    of each output's largest: ``TAIL_REF``."""
    inte, h, v, dy = _tail_case(2)
    bf = jnp.bfloat16
    if gated:
        w2 = (J(v["w2k"]).astype(bf), J(v["w2b"]), J(v["s2"]), J(v["t2"]))
    else:
        w2 = (None,) * 4
    args = (J(v["partial"]), inte[1], h[1] if gated else None, J(v["isc"]),
            J(v["ish"])) + w2 + (J(v["wi"]).astype(bf), J(v["bias"]))
    live = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, a in zip(live, xs):
            full[i] = a
        return _reference(*full, K, True)

    ref = dict(zip((TAIL_NAMES[i] for i in live),
                   _vjp(f, tuple(args[i] for i in live), dy[1])))
    got = _tail_port(inte, h, v, dy, gated)
    for name, g in zip(TAIL_NAMES, got):
        if g is None:
            continue
        r = np.asarray(ref[name], np.float32).reshape(tuple(g.shape))
        assert rel(g.float(), r) <= TAIL_REF[name], (name, rel(g.float(), r))


def test_slot_stats_bwd_matches_jax():
    """Slot stats' backward on bf16 ``h``: fp32 product of the upcast, dh
    rounded to bf16, against JAX's ``_bwd`` (pdgn_tpu/ops/pallas/
    slot_stats.py:120-127)."""
    rng = np.random.RandomState(3)
    k = 6
    h_t, h_j = bf16_pair(rng.randn(2, 40, k * 64))
    ds = rng.randn(64).astype(F)
    dS = (rng.randn(64, 64) * 0.1).astype(F)
    (want,) = jslot._bwd(k, False, h_j, (J(ds), J(dS)))
    got = stats_bwd(h_t, T(ds), T(dS))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert bf16_ulps(got, np.asarray(want, np.float32)) <= 1.0


def test_bf16_autograd_takes_the_plain_backwards():
    """bf16 CPU tensors through the differentiable entries: the head's,
    the tails' and slot stats' backward run their plain bf16 versions (no
    launch), fp32 weights get fp32 gradients, bf16 activations bf16 ones;
    a dtype with no instance is refused."""
    _lib.LAUNCHES.clear()
    x, idx, w, pc, inte, cts = _head_case(4, True)
    xr = x[0].clone().requires_grad_(True)
    ck = T(np.random.RandomState(4).randn(1, WINDOW, 2 * C, FOUR_FIN)
           .astype(F) * 0.1).requires_grad_(True)
    mk = T(np.random.RandomState(5).randn(2 * K * 2 * C, TWO_F)
           .astype(F) * 0.05).requires_grad_(True)
    cb = torch.zeros(FOUR_FIN, requires_grad=True)
    out = edge_conv_head(xr, ck, cb, mk, K, pc[0][0], pc[1][0])
    (out[1].float().sum() + out[2].sum() + out[4].float().sum()).backward()
    assert xr.grad.dtype == BF and ck.grad.dtype == torch.float32
    assert mk.grad.dtype == torch.float32
    assert all(torch.isfinite(g).all() for g in (xr.grad.float(), ck.grad,
                                                 mk.grad))
    inte_t, h, v, dy = _tail_case(4)
    wi = T(np.random.RandomState(6).randn(2 * K * 8, TWO_F).astype(F)
           * 0.05).requires_grad_(True)
    w2k = T(v["w2k"]).requires_grad_(True)
    stats = tuple(T(v[n]) for n in ("ish", "isc", "isc", "ish"))
    hh = h[0].clone().requires_grad_(True)
    y = edge_conv_tail(T(v["partial"]), inte_t[0], hh, stats,
                       (w2k, T(v["w2b"])), tuple(T(v[n]) for n in (
                           "w2b", "s2", "s2", "t2")), wi, T(v["bias"]), K)
    assert y.dtype == BF
    y.float().sum().backward()
    assert wi.grad.dtype == w2k.grad.dtype == torch.float32
    assert hh.grad.dtype == BF
    hs = h[0].clone().requires_grad_(True)
    slot_moment_stats(hs, K)[1].sum().backward()
    assert hs.grad.dtype == BF
    assert sum(_lib.LAUNCHES.values()) == 0
    with pytest.raises(TypeError):
        slot_moment_stats(torch.zeros(2, 8, K * 64, dtype=torch.float16), K)
