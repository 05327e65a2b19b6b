"""Each generator stage's backward under ``--compute_dtype bfloat16``: the
port's ``BilateralBlock`` (its CPU path: the plain bf16 forwards and
backwards of the head, slot stats and tail, and autograd through the rest)
against ``jax.vjp`` of the JAX package's bf16 block, fed the same bf16
inputs, the same weights and the same cotangents on ``xs``, ``g`` and
``ec``, with the port's graph injected into JAX as in
tests/test_torch_bf16_generator.py (fp32-exact kNN regime, XLA's excess
precision off).

This is the whole-slice check between the kernel tests and the train
step. At the step (tests/test_torch_bf16_train_step.py) the generator's
Adam first moment lies 0.41 from JAX's in every parameter alike, from
``fc1`` to the coordinate heads, and planted faults in the plain bf16
backwards move that by -0.003 to +0.05: the step cannot tell them apart.
A stage fed identical inputs can see a wrong term.

Small configuration: base_points 16, B=4, num_k 20, seeded weights with
random batch-norm parameters. Measured here, relative L2 to JAX's: the
stage's parameter gradients 5.3e-3, 4.4e-3, 4.6e-3, 4.5e-3 (stage 1..4);
the input cotangents 6.1e-3 to 9.9e-3. What is left is the two sides'
forward roundings (tests/test_torch_bf16_generator.py: 0.2-0.6% of ec's
entries differ by an ulp). Routing stage 4's head and tail backward
through the interpret-mode Pallas bodies takes its parameter gap from
4.5e-3 only to 4.2e-3, so JAX's own CPU path is the oracle here. Limits:
parameters 8e-3, inputs 1.5e-2.

Planted faults, one at a time, measured: the head's statistics cotangent
without its variance term reads 9.5e-3 to 3.9e-2 on the parameters and
2.4e-2 to 3.3e-2 on ``xs_in``; the gate's softmax backward without its
centring term reads 2.4e-2 to 2.9e-2 on the parameters and 1.2 on
``pc``. A missing or extra bf16 rounding of one operand (the head's
window cotangent, the tail's slot-logit cotangent, the gate product
rounded three times, the head's low bf16 part of A dropped) moves these
readings by at most 7.2e-4, down as often as up: below what a stage can
resolve; tests/test_torch_bf16_train_kernels.py holds those.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (bf16_pair, one_torch_thread,  # noqa: F401
                             perturbed_state)

import pdgn_tpu.models.generator as jgen
import pdgn_tpu.ops.edges as jedges
from pdgn_tpu.convert_ckpt import convert_generator
from pdgn_tpu.ops.edges import exact_knn_scope
from pdgn_tpu_torch.convert_ckpt import generator_state_from_jax
from pdgn_tpu_torch.models.generator import PointGenerator

BASE = 16
B = 4
BF = torch.bfloat16


@pytest.fixture(scope="module")
def weights():
    state = perturbed_state(PointGenerator(base_points=BASE), 0)
    v, _ = convert_generator({k: x.numpy() for k, x in state.items()})
    v = jax.tree.map(jnp.asarray, v)
    model = PointGenerator(base_points=BASE, dtype=BF)
    model.load_state_dict(state)
    return v["params"], v["batch_stats"], model


class _Graphs:
    """``_neighbor_idx`` handing out the port's graphs in trace order."""

    def __init__(self, graphs):
        self.queue = [np.asarray(g) for g in graphs]

    def __call__(self, x, k):
        g = self.queue.pop(0)
        assert g.shape == (x.shape[0], x.shape[1], k)
        return jnp.asarray(g)


def _stage_inputs(stage):
    fin = 32 * 2 ** (stage - 1)
    n = BASE * 2 ** (stage - 1)
    rng = np.random.RandomState(50 + stage)
    if stage == 1:
        return [bf16_pair(rng.randn(B, n, fin))], {}
    return ([bf16_pair(rng.randn(B, n, fin // 2)),
             bf16_pair(rng.randn(B, n, 3) * 0.3)],
            {"xs_in": bf16_pair(rng.randn(B, fin // 2))})


def _l2(a, b):
    a, b = (np.asarray(v, np.float64).ravel() for v in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_bf16_stage_backward_matches_jax(weights, stage, monkeypatch):
    """Parameter gradients rel L2 <= 8e-3, input cotangents <= 1.5e-2
    (module docstring); parameter gradients fp32, input cotangents in the
    inputs' bf16."""
    params, stats, model = weights
    fin = 32 * 2 ** (stage - 1)
    name = f"bilateral{stage}"
    args, kw = _stage_inputs(stage)
    block = getattr(model, name)
    block.train()
    ins = [a[0].clone().requires_grad_(True) for a in args]
    kins = {k: x[0].clone().requires_grad_(True) for k, x in kw.items()}
    xs, g, ec, idx = block(*ins, **kins)
    outs = (xs, g, ec)
    rng = np.random.RandomState(70 + stage)
    cts = [None if o is None else bf16_pair(rng.randn(*o.shape))
           for o in outs]
    live = [(o, c[0].to(o.dtype)) for o, c in zip(outs, cts)
            if o is not None]
    pnames = [n for n, _ in block.named_parameters()]
    grads = torch.autograd.grad(
        [o for o, _ in live],
        list(block.parameters()) + ins + list(kins.values()),
        [c for _, c in live])

    mod = jgen.BilateralBlock(fin, fin, 10, bilateral=stage > 1,
                              with_g=stage < 4, dtype="bfloat16", name=name)

    def vjp(p, a, k, c):
        def f(p, a, k):
            return mod.apply({"params": p, "batch_stats": stats[name]}, *a,
                             mutable=["batch_stats"], **k)[0]

        return jax.vjp(f, p, a, k)[1](c)

    jcts = tuple(None if c is None else c[1].astype(
        jnp.bfloat16 if o.dtype == BF else jnp.float32)
        for c, o in zip(cts, outs))
    ja = tuple(a[1] for a in args)
    jk = {k: x[1] for k, x in kw.items()}
    monkeypatch.setattr(jedges, "_neighbor_idx", _Graphs([idx]))
    with exact_knn_scope(True):
        dp, da, dk = jax.jit(vjp).lower(params[name], ja, jk, jcts).compile(
            compiler_options={"xla_allow_excess_precision": False})(
                params[name], ja, jk, jcts)

    full = dict(jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                             params))
    full[name] = jax.tree.map(lambda x: np.asarray(x, np.float32), dp)
    want = generator_state_from_jax(full, jax.tree.map(np.asarray, stats))
    got_p = grads[:len(pnames)]
    assert all(gr.dtype == torch.float32 for gr in got_p)
    e = _l2(torch.cat([gr.flatten() for gr in got_p]),
            torch.cat([want[f"{name}.{n}"].flatten() for n in pnames]))
    assert e <= 8e-3, ("parameters", e)
    for i, (gr, w) in enumerate(zip(grads[len(pnames):],
                                    list(da) + list(dk.values()))):
        assert gr.dtype == BF and w.dtype == jnp.bfloat16, i
        e = _l2(gr.float(), np.asarray(w, np.float32))
        assert e <= 1.5e-2, (i, e)
