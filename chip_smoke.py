#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pdgn_tpu_torch``) on one GPU.

Run from the root of the repository with no arguments::

    python3 chip_smoke.py [--out results.json]

What it does, in order (any failure raises and the exit code is not 0):

1. prints the card (``nvidia-smi``), torch and CUDA versions, and builds
   the CUDA kernels from ``pdgn_tpu_torch/csrc`` (timed);
2. holds each kernel against its plain PyTorch version on the card, TF32
   off, at the generator's stage-4 shapes (B=8), plus stage 1 for the
   plain head and the plain tail. kNN indices may differ only at near-ties
   (every mismatched neighbour's distance within 1e-5 relative of the one
   it replaces, at most 0.1% of entries); given the kernel's indices the
   head's other outputs are rel <= 1e-4; slot stats rel <= 1e-5; the tails
   rel <= 1e-4. ``rel`` is max |a - b| / max |b|;
3. drives the main path: ``generate()`` (the ``--phase sample`` entry) at
   full width, 256 clouds in batches of 128 from a seeded random init,
   with every launch counter set to 0 just before and read just after;
   checks the clouds (finite, (256, 2048, 3)), the counters (4 head,
   3 slot-stats, 3 gated-tail and 1 plain-tail launches per forward) and
   that the running statistics did not move; then feeds every stage on the
   card the inputs the plain CPU path gave that stage (B=8) and holds the
   stage outputs to rel <= 1e-3 at every point whose kNN row agrees (a
   differing row must be a near-tie, relative distance gap <= 1e-5);
4. times clouds/s at B=128 and, per kernel at the main path's B=128
   shapes, the kernel, its plain version and (where one PyTorch call
   computes the same function) that call, beside the least time the card
   could take (max of bytes / 3.35 TB/s and FLOP / 67 TFLOP/s, the H100
   SXM fp32 figures without tensor cores); holds each kernel's B=128
   outputs against its plain version's with phase 2's tolerances and
   near-tie rule.

The train slice, in the same phases:

2t. the backward kernels and the local-stats kernels against their plain
   versions at stage-4 shapes, B=8: the head's and the tails' gradients rel
   <= 1e-4 given the same graph and the same random cotangents, except
   where fp32 is worse conditioned than that (the gated tail's d h, d w2k,
   d w2b, d s2, d t2 through the slot softmax: the plain version is 2e-4
   to 1.2e-2 off its own float64 evaluation at these shapes); there the
   kernel's error against float64 is at most twice the plain version's;
   ``local_mean_cov`` forward with neighbour sets equal except at near-ties
   (PR 1's rule), mu and cov rel <= 1e-4 over the centers whose sets agree,
   its backward rel <= 1e-4 given the same selection;
3t. drives the train path through the trainer's entry point
   (``PDGNTrainer.train``, what ``--phase train`` runs) at full width,
   B=35, synthetic data: four steps (one warm-up, three timed) with every
   launch counter set to 0 just before and read just after. Checks the six
   losses are finite, every G and D parameter has a finite gradient, the G
   parameters moved, the launch counts per step (head 8 forward and 4
   backward, slot stats 6, gated tail 6 and 3, plain tail 2 and 1, local
   stats 9 and 9), and that both checkpoint bundles were written and load
   back; prints train steps/s at B=35;
4t. times each train kernel at the train path's B=35 shapes beside its plain
   version and its bound, and holds its outputs to phase 2t's tolerances.

Last, it prints the ``{"kernels": [...]}`` line, then the ``{"ok": ...}``
line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import time

PEAK_FLOPS = 67e12       # H100 SXM fp32, no tensor cores (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
K = 10                   # neighbours per stage (num_k 20 halved)
SEED = 2024


def log(msg: str) -> None:
    print(msg, flush=True)


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-12))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def stage_dims(stage: int):
    """Full-width shapes of stage ``stage``: N, per-point C, xs width cx,
    4Fin, 2F."""
    fin = 32 * 2 ** (stage - 1)
    n = 128 * 2 ** (stage - 1)
    if stage == 1:
        return n, fin, 0, 4 * fin, 2 * fin
    return n, fin // 2, fin // 2, 4 * fin, 2 * fin


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ inputs
def head_inputs(stage: int, B: int, gated: bool, gen, dev):
    """Prepared operands of the edge head at a stage's full-width shapes,
    from seeded random features and weights."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import head_operands

    n, c, cx, four_fin, two_f = stage_dims(stage)
    cf = c + cx
    window = K // 2 + 1

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x = r(B, n, c)
    xs = r(B, cx) if cx else None
    conv_kernel = r(1, window, 2 * cf, four_fin,
                    scale=(2 * cf * window) ** -0.5)
    conv_bias = r(four_fin, scale=0.1)
    merge_kernel = r(2 * K * 2 * cf, two_f, scale=(4 * K * cf) ** -0.5)
    ops = head_operands(x, conv_kernel, conv_bias, merge_kernel, K, xs)
    pcat = r(B, n, 32) if gated else None
    ppoint = r(B, n, 32) if gated else None
    x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, window = ops
    return (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
            pcat, ppoint, K, window)


def tail_inputs(stage: int, B: int, gated: bool, gen, dev):
    import torch

    n, _, _, four_fin, two_f = stage_dims(stage)
    hk = K // 2
    two_fin = four_fin // 2

    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    partial = r(B, n, two_f)
    inte = r(B, n, hk * four_fin)
    isc = r(four_fin, scale=0.2, shift=1.0)
    ish = r(four_fin, scale=0.1)
    wi = r(hk * four_fin, two_f, scale=(hk * four_fin) ** -0.5)
    bias = r(two_f, scale=0.1)
    if not gated:
        return (partial, inte, None, isc, ish, None, None, None, None, wi,
                bias, K, True)
    h = r(B, n, K * 64, scale=0.5)
    w2k = r(64, two_fin, scale=0.125)
    w2b = r(two_fin, scale=0.1)
    s2 = r(two_fin, scale=0.2, shift=1.0)
    t2 = r(two_fin, scale=0.1)
    return (partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias, K, True)


# ------------------------------------------------------- kernel vs plain
def compare_head(args, label: str) -> float:
    """The edge head's kernel against its plain version on ``args``: kNN
    indices equal except at near-ties, the other outputs (given the
    kernel's indices) rel <= 1e-4. Returns the largest absolute error."""
    import torch
    from pdgn_tpu_torch.ops.edges import neighbor_idx
    from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                      head_reference_given_idx)
    from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

    (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, pcat,
     ppoint, k, window) = args
    got = edge_head(*args)
    torch.cuda.synchronize()
    idx_k = got[0]
    idx_p = neighbor_idx(x_knn, k)
    mism = idx_k != idx_p
    frac = float(mism.float().mean())
    gap = 0.0
    if bool(mism.any()):
        d = self_pairwise_sqdist(x_knn)
        dk = d.gather(-1, idx_k.long())
        dp = d.gather(-1, idx_p.long())
        scale = torch.maximum(dk.abs(), dp.abs()).clamp_min(1e-12)
        gap = float(((dk - dp).abs() / scale)[mism].max())
        del d, dk, dp, scale
    log(f"  head {label}: idx mismatch {frac:.6f} "
        f"({int(mism.sum())} entries, max near-tie gap {gap:.3e})")
    require(frac <= 1e-3, f"head {label}: {frac} of idx differ")
    require(gap <= 1e-5, f"head {label}: idx differ beyond near-ties")
    del idx_p, mism
    want = head_reference_given_idx(x, wn_flat, conv_a, pb_point, a_merge,
                                    wen, pb_merge, pcat, ppoint, idx_k, k,
                                    window)
    names = ("inte", "partial", "stats", "wfea", "wxyz", "wstats")
    err = 0.0
    for name, g, w in zip(names, got[1:], want):
        if w is None:
            require(g is None, f"head: {name} should be None")
            continue
        e = rel(g, w)
        log(f"    {name}: rel {e:.3e}")
        require(e <= 1e-4, f"head {label}: {name} rel {e}")
        err = max(err, max_abs(g, w))
    return err


def compare_slot_stats(h, label: str) -> float:
    """Slot stats' kernel against its plain version: rel <= 1e-5."""
    from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                       stats_plain)

    s_k, S_k = slot_moment_stats(h, K)
    s_p, S_p = stats_plain(h, K)
    e1, e2 = rel(s_k, s_p), rel(S_k, S_p)
    log(f"  slot_stats {label}: s rel {e1:.3e}, S rel {e2:.3e}")
    require(e1 <= 1e-5 and e2 <= 1e-5, f"slot_stats {label} disagrees")
    return max(max_abs(s_k, s_p), max_abs(S_k, S_p))


def compare_tail(args, label: str) -> float:
    """A tail's kernel against its plain version: rel <= 1e-4."""
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import tail, tail_reference

    y_k = tail(*args)
    y_p = tail_reference(*args)
    e = rel(y_k, y_p)
    log(f"  tail {label}: rel {e:.3e}")
    require(e <= 1e-4, f"tail {label} disagrees: {e}")
    return max_abs(y_k, y_p)


# ------------------------------------------------------------ phase 3: path
def stage_check(model, dev) -> dict:
    """Feed each stage on the card the inputs the plain CPU path gave it;
    stage outputs rel <= 1e-3 where the kNN rows agree."""
    import torch
    from pdgn_tpu_torch.train.sampler import frozen_running_stats

    cpu_model = copy.deepcopy(model).cpu()
    records = {}

    def hook(name):
        def fn(module, args, kwargs, output):
            records[name] = (args, kwargs, output)
        return fn

    handles = [getattr(cpu_model, f"bilateral{i}").register_forward_hook(
        hook(f"bilateral{i}"), with_kwargs=True) for i in range(1, 5)]
    z = torch.randn(8, 128, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad(), frozen_running_stats(cpu_model):
        cpu_model(z)
    for h in handles:
        h.remove()

    def to_dev(v):
        return v.to(dev) if isinstance(v, torch.Tensor) else v

    from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

    out = {}
    with torch.no_grad(), frozen_running_stats(model):
        for name, (args, kwargs, want) in records.items():
            got = getattr(model, name)(*map(to_dev, args),
                                       **{k: to_dev(v)
                                          for k, v in kwargs.items()})
            idx_g, idx_w = got[3].cpu(), want[3]
            mism = idx_g != idx_w
            gap = 0.0
            if bool(mism.any()):
                # a flipped neighbour must be a near-tie of the graph input
                x = args[0]
                xs_in = kwargs.get("xs_in")
                if xs_in is not None:
                    x = torch.cat([xs_in[:, None, :].expand(
                        -1, x.shape[1], -1), x], dim=-1)
                d = self_pairwise_sqdist(x)
                dg = d.gather(-1, idx_g.long())
                dw = d.gather(-1, idx_w.long())
                scale = torch.maximum(dg.abs(), dw.abs()).clamp_min(1e-12)
                gap = float(((dg - dw).abs() / scale)[mism].max())
            require(gap <= 1e-5, f"{name}: graph differs beyond near-ties")
            # points whose neighbour lists differ legitimately give other
            # outputs (both copies after the point doubling): compare the rest
            keep = ~mism.any(-1)
            keep2 = torch.cat([keep, keep], dim=1)
            errs = [rel(got[0].cpu(), want[0]),
                    rel(got[2].cpu()[keep2], want[2][keep2])]
            if want[1] is not None:
                errs.append(rel(got[1].cpu(), want[1]))
            idx_diff = float(mism.float().mean())
            log(f"  {name}: stage outputs rel {max(errs):.3e} "
                f"(points with other neighbour lists left out: "
                f"{int((~keep).sum())}), graph entries differing "
                f"{idx_diff:.6f}, max near-tie gap {gap:.3e}")
            require(max(errs) <= 1e-3, f"{name}: stage outputs rel "
                    f"{max(errs)}")
            out[name] = {"rel": max(errs), "idx_differ": idx_diff,
                         "points_left_out": int((~keep).sum()),
                         "near_tie_gap": gap}
    return out


def main_path(dev) -> dict:
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train.generate import build_generator, generate

    model = build_generator(SEED, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    clouds = generate(256, 128, SEED, device=dev, model=model)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"  generate(256, B=128): {clouds.shape} in {first_s:.3f} s, "
        f"launches {launches}")
    require(clouds.shape == (256, 2048, 3), f"shape {clouds.shape}")
    import numpy as np
    require(bool(np.isfinite(clouds).all()), "non-finite clouds")
    forwards = 2
    want = {"edge_head": 4 * forwards, "slot_stats": 3 * forwards,
            "bilateral_tail_gated": 3 * forwards,
            "bilateral_tail_plain": 1 * forwards}
    require(launches == want, f"launches {launches} != {want}")
    after = model.state_dict()
    require(all(torch.equal(before[k], after[k]) for k in before),
            "sampling moved the running statistics")

    stages = stage_check(model, dev)

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(256, 128, SEED, device=dev, model=model)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    cps = [256 / s for s in times]
    log(f"  clouds/s at B=128 (256 clouds per run): {cps}")
    return {"launches": launches, "stages": stages, "clouds_per_s": cps,
            "first_run_s": first_s, "model": model}


# ------------------------------------------------------------ phase 4: times
def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def time_kernels(dev, gen) -> dict:
    """Times each kernel, its plain version and the library call at the
    main path's B=128 shapes, and holds the kernel's outputs against the
    plain ones on the same inputs with phase 2's tolerances."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import tail, tail_reference
    from pdgn_tpu_torch.ops.kernels.edge_head import edge_head, head_plain
    from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                       stats_plain)

    B = 128
    hk = K // 2
    window = hk + 1
    res = {}

    # edge head, gated, stage 4
    n, c, cx, four_fin, two_f = stage_dims(4)
    args = head_inputs(4, B, True, gen, dev)
    rows = B * n
    flops = (2.0 * B * n * n * c                       # kNN distances
             + 2.0 * rows * c * four_fin                 # x @ conv_a
             + 2.0 * rows * hk * window * c * four_fin   # window conv
             + 2.0 * rows * (K + 1) * c * two_f          # merge partial
             + 2.0 * rows * K * 32)                      # weight-net rows
    nbytes = 4.0 * (rows * c + B * cx + rows * 64        # x, xs, pcat+ppoint
                    + (window + 1) * c * four_fin + (K + 1) * c * two_f
                    + B * (four_fin + two_f)             # weights, biases
                    + rows * K                           # idx
                    + rows * hk * four_fin + rows * two_f + 2 * four_fin
                    + rows * K * 32 + 2 * K * 32)        # outputs
    b, by = bound(flops, nbytes)
    res["edge_head"] = {
        "ms": time_ms(lambda: edge_head(*args), 3),
        "plain_ms": time_ms(lambda: head_plain(*args), 2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, C={c}+{cx}, 4Fin={four_fin}, "
                 f"2F={two_f}, gated"}
    res["edge_head"]["max_abs_err"] = compare_head(args, f"stage 4 B={B}")
    del args

    # slot stats, stage 4
    h = torch.randn(B, n, K * 64, generator=gen, device=dev)
    srows = B * n * K
    # S is symmetric: 64*65/2 distinct dot products of 2 FLOP per row,
    # plus the 64 adds of s
    b, by = bound(srows * (64 * 65 + 64),
                  4.0 * (srows * 64 + 64 * 64 + 64))
    hf = h.reshape(-1, 64)
    res["slot_stats"] = {
        "ms": time_ms(lambda: slot_moment_stats(h, K), 10),
        "plain_ms": time_ms(lambda: stats_plain(h, K), 10),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.matmul(hf.T, hf), 10),
        "shape": f"stage 4, B={B}, rows={srows}, H=64"}
    res["slot_stats"]["max_abs_err"] = compare_slot_stats(h, f"stage 4 B={B}")
    del h, hf

    # gated tail, stage 4
    targs = tail_inputs(4, B, True, gen, dev)
    two_fin = four_fin // 2
    flops = (2.0 * rows * K * 64 * two_fin               # conv_all2
             + 2.0 * rows * hk * four_fin * two_f        # merge GEMM
             + 8.0 * rows * K * two_fin)                 # BN, gates, softmax
    nbytes = 4.0 * (rows * two_f * 2 + rows * hk * four_fin + rows * K * 64
                    + hk * four_fin * two_f + 64 * two_fin + 2 * four_fin)
    b, by = bound(flops, nbytes)
    res["bilateral_tail_gated"] = {
        "ms": time_ms(lambda: tail(*targs), 3),
        "plain_ms": time_ms(lambda: tail_reference(*targs), 3),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, 4Fin={four_fin}, 2F={two_f}"}
    res["bilateral_tail_gated"]["max_abs_err"] = compare_tail(
        targs, f"stage 4 B={B} gated")
    del targs

    # plain tail, stage 1
    n1, _, _, four_fin1, two_f1 = stage_dims(1)
    targs = tail_inputs(1, B, False, gen, dev)
    rows1 = B * n1
    flops = 2.0 * rows1 * hk * four_fin1 * two_f1 + 3.0 * rows1 * hk * four_fin1
    nbytes = 4.0 * (rows1 * two_f1 * 2 + rows1 * hk * four_fin1
                    + hk * four_fin1 * two_f1 + 2 * four_fin1)
    b, by = bound(flops, nbytes)
    res["bilateral_tail_plain"] = {
        "ms": time_ms(lambda: tail(*targs), 10),
        "plain_ms": time_ms(lambda: tail_reference(*targs), 10),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 1, B={B}, N={n1}, 4Fin={four_fin1}, 2F={two_f1}"}
    res["bilateral_tail_plain"]["max_abs_err"] = compare_tail(
        targs, f"stage 1 B={B} plain")
    return res


# ----------------------------------------------- the train slice: phase 2t
def head_bwd_case(stage: int, B: int, gated: bool, gen, dev):
    """Operands, the kernel's graph and forward, and random cotangents of
    the head at a stage's full-width shapes."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import edge_head

    args = head_inputs(stage, B, gated, gen, dev)
    idx, inte = edge_head(*args)[:2]
    n, _, _, four_fin, two_f = stage_dims(stage)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cts = [r(*inte.shape), r(B, n, two_f), r(2, four_fin, scale=0.01)]
    if gated:
        cts += [r(B, n, K * 16), r(B, n, K * 16), r(2, K * 32, scale=0.01)]
    return args, idx, inte, cts


HEAD_GRADS = ("x", "wn_flat", "conv_a", "pb_point", "a_merge", "wen",
              "pb_merge", "pcat", "ppoint")
TAIL_GRADS = ("partial", "inte", "h", "isc", "ish", "w2k", "w2b", "s2",
              "t2", "wi", "bias")


def _double(args):
    return [a.double() if hasattr(a, "double") and a.is_floating_point()
            else a for a in args]


def compare_grads(names, got, want, want64, label: str) -> float:
    """Every gradient of the kernel rel <= 1e-4 of the plain version's; where
    fp32 itself is worse conditioned than that (the plain version's own
    error against its float64 evaluation on the same inputs exceeds 5e-5),
    the kernel's error against float64 must stay within twice the plain
    version's. Returns the largest absolute error against the plain
    version."""
    err = 0.0
    worst = 0.0
    for name, g, w, w64 in zip(names, got, want, want64):
        if w is None:
            require(g is None, f"{label}: {name} should be None")
            continue
        require(g.shape == w.shape, f"{label}: {name} shape {g.shape}")
        e = rel(g, w)
        worst = max(worst, e)
        if e > 1e-4:
            e_k, e_p = rel(g, w64), rel(w, w64)
            log(f"    d{name}: rel {e:.3e} to the plain version; to float64 "
                f"kernel {e_k:.3e}, plain {e_p:.3e}")
            require(e_p > 5e-5 and e_k <= 2 * e_p,
                    f"{label}: d{name} rel {e}, to float64 {e_k} vs {e_p}")
        err = max(err, max_abs(g, w))
    log(f"  {label}: gradients rel <= {worst:.3e} to the plain version")
    return err


def compare_head_bwd(case, label: str) -> float:
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain)

    args, idx, inte, cts = case
    x, _, wn, ca, pb, am, wen, pbm, pcat, ppoint, k, window = args
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                          k)
    plain_args = (x, idx, wn, ca, pb, am, wen, pbm, pcat, ppoint)
    want = head_bwd_plain(*plain_args, cts, k, window)
    want64 = head_bwd_plain(*_double(plain_args), _double(cts), k, window)
    return compare_grads(HEAD_GRADS, got, want, want64, f"head bwd {label}")


def compare_tail_bwd(args, dy, label: str) -> float:
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_bwd_plain)

    k, softmax = args[11], args[12]
    got = tail_bwd_kernel(*args[1:10], dy, k, softmax)
    want = tail_bwd_plain(*args[:11], dy, k, softmax)
    want64 = tail_bwd_plain(*_double(args[:11]), dy.double(), k, softmax)
    return compare_grads(TAIL_GRADS, got, want, want64, f"tail bwd {label}")


def local_case(B: int, M: int, N: int, gen, dev):
    """A coarse cloud of M centers and a finer cloud of N points around
    it (the shape loss's cross pair), with cotangents."""
    import torch

    centers = torch.randn(B, M, 3, generator=gen, device=dev)
    reps = -(-N // M)
    src = (centers.repeat(1, reps, 1)[:, :N]
           + 0.05 * torch.randn(B, N, 3, generator=gen, device=dev))
    g_mu = torch.randn(B, M, 3, generator=gen, device=dev)
    g_cov = torch.randn(B, M, 9, generator=gen, device=dev)
    return src.contiguous(), centers, g_mu, g_cov


def compare_local(case, label: str):
    """Forward: neighbour sets equal except at near-ties (at most 0.1% of
    the centers, each mismatched neighbour within 1e-5 relative distance of
    the one it replaces); mu and cov rel <= 1e-4 over the centers whose sets
    agree. Backward rel <= 1e-4 given the kernel's selection. Returns the
    largest absolute errors of the forward and the backward."""
    import torch
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel,
                                                        bwd_plain,
                                                        fwd_kernel,
                                                        knn_direct,
                                                        stats_given_idx)

    src, centers, g_mu, g_cov = case
    k = 20
    idx_k, mu, cov = fwd_kernel(src, centers, k)
    idx_p = knn_direct(src, centers, k)
    set_k = torch.sort(idx_k, -1).values
    set_p = torch.sort(idx_p, -1).values
    differ = (set_k != set_p).any(-1)
    frac = float(differ.float().mean())
    gap = 0.0
    if bool(differ.any()):
        d = ((centers[:, :, None, :] - src[:, None, :, :]) ** 2).sum(-1)
        dk = d.gather(-1, idx_k.long()).sort(-1).values
        dp = d.gather(-1, idx_p.long()).sort(-1).values
        scale = torch.maximum(dk.abs(), dp.abs()).clamp_min(1e-12)
        gap = float(((dk - dp).abs() / scale)[differ].max())
        del d, dk, dp
    require(frac <= 1e-3 and gap <= 1e-5,
            f"local stats {label}: {frac} of the sets differ, gap {gap}")
    keep = ~differ
    mu_p, cov_p = stats_given_idx(src, idx_p.long())
    e_mu = rel(mu[keep], mu_p[keep])
    e_cov = rel(cov[keep], cov_p[keep])
    d_k = bwd_kernel(src, idx_k, mu, g_mu, g_cov)
    d_p = bwd_plain(src, idx_k, g_mu, g_cov)
    e_b = rel(d_k, d_p)
    log(f"  local_stats {label}: sets differ at {frac:.6f} of the centers "
        f"(max near-tie gap {gap:.3e}), mu rel {e_mu:.3e}, cov rel "
        f"{e_cov:.3e}, d_src rel {e_b:.3e}")
    require(e_mu <= 1e-4 and e_cov <= 1e-4, f"local stats {label} fwd")
    require(e_b <= 1e-4, f"local stats {label} bwd: {e_b}")
    return (max(max_abs(mu[keep], mu_p[keep]), max_abs(cov[keep], cov_p[keep])),
            max_abs(d_k, d_p))


def check_train_kernels(gen, dev) -> dict:
    """Phase 2t at stage-4 shapes (stage 1 for the plain tail), B=8."""
    import torch

    errs = {}
    errs["edge_head_bwd"] = max(
        compare_head_bwd(head_bwd_case(4, 8, True, gen, dev), "stage 4 B=8"),
        compare_head_bwd(head_bwd_case(1, 8, False, gen, dev), "stage 1 B=8"))
    for name, stage, gated in (("bilateral_tail_gated_bwd", 4, True),
                               ("bilateral_tail_plain_bwd", 1, False)):
        args = tail_inputs(stage, 8, gated, gen, dev)
        dy = torch.randn(*args[0].shape, generator=gen, device=dev)
        errs[name] = compare_tail_bwd(args, dy, f"stage {stage} B=8")
    errs["local_stats_fwd"], errs["local_stats_bwd"] = compare_local(
        local_case(8, 1024, 2048, gen, dev), "M=1024 N=2048 B=8")
    return errs


# ----------------------------------------------- the train slice: phase 3t
TRAIN_B = 35
TRAIN_STEPS = 4          # one warm-up, three timed
PER_STEP = {"edge_head": 8, "edge_head_bwd": 4, "slot_stats": 6,
            "bilateral_tail_gated": 6, "bilateral_tail_gated_bwd": 3,
            "bilateral_tail_plain": 2, "bilateral_tail_plain_bwd": 1,
            "local_stats_fwd": 9, "local_stats_bwd": 9}


def train_path(root: str) -> dict:
    """The train path through the trainer at full width, B=35."""
    import math

    import numpy as np
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train import checkpoint as ckpt_lib
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    ckpt_root = os.path.join(root, "pdgn_tpu_torch", "_build", "smoke_train")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    cfg = ExperimentConfig(batch_size=TRAIN_B, max_epoch=1,
                           max_steps_per_epoch=TRAIN_STEPS,
                           synthetic_size=TRAIN_B * TRAIN_STEPS,
                           checkpoint_dir=ckpt_root, model_dir="smoke",
                           device="cuda")
    trainer = PDGNTrainer(cfg)
    trainer.build_model(seed=SEED)
    st = trainer.state
    n_g = sum(p.numel() for p in st.generator.parameters())
    require(n_g == 12_711_372, f"generator has {n_g} parameters")
    g_before = [p.detach().clone() for p in st.generator.parameters()]
    np.random.seed(SEED)
    try:
        _lib.LAUNCHES.clear()
        trainer.train(seed=SEED)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        steps = len(trainer.step_seconds)
        log(f"  {steps} train steps at B={TRAIN_B}, launches {launches}")
        require(steps == TRAIN_STEPS, f"{steps} steps ran")
        want = {k: v * steps for k, v in PER_STEP.items()}
        require(launches == want, f"launches {launches} != {want}")
        m = trainer.last_metrics
        require(len(m) == 6 and all(math.isfinite(v) for v in m.values()),
                f"losses {m}")
        for net in (st.generator,) + st.discriminators:
            for name, p in net.named_parameters():
                require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                        f"{name}: no finite gradient")
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(g_before, st.generator.parameters()))
        require(moved > 0, "the generator's parameters did not move")
        path_g = os.path.join(trainer.ckpt_dir, "1_full_G.pth")
        path_d = os.path.join(trainer.ckpt_dir, "1_full_D.pth")
        require(os.path.isfile(path_g) and os.path.isfile(path_d),
                "checkpoint bundles missing")
        other = PDGNTrainer(cfg)
        other.build_model(seed=SEED + 1)
        epoch = ckpt_lib.load(path_g, path_d, other.state)
        for a, b in zip((st.generator,) + st.discriminators,
                        (other.state.generator,) + other.state.discriminators):
            sa, sb = a.state_dict(), b.state_dict()
            require(all(torch.equal(sa[k], sb[k]) for k in sa),
                    "a loaded bundle differs from the trained models")
        require(epoch == 1, f"G_epoch {epoch}")
        del other
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    timed = trainer.step_seconds[1:]
    sps = len(timed) / sum(timed)
    log(f"  train step seconds {trainer.step_seconds}; steps/s at "
        f"B={TRAIN_B} over the {len(timed)} timed steps: {sps:.4f}; last "
        f"losses {m}; generator tensors moved {moved}")
    return {"launches": launches, "steps_per_s": sps,
            "step_seconds": trainer.step_seconds, "metrics": m,
            "per_step": {k: v // steps for k, v in launches.items()}}


# ----------------------------------------------- the train slice: phase 4t
def time_train_kernels(dev, gen) -> dict:
    """Times each train kernel, its plain version, at the train path's
    B=35 shapes, beside its bound; holds the outputs to phase 2t's
    tolerances on the same inputs."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_bwd_plain)
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain)
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel,
                                                        bwd_plain,
                                                        fwd_kernel,
                                                        knn_direct,
                                                        stats_given_idx)

    B = TRAIN_B
    hk = K // 2
    window = hk + 1
    res = {}

    # head backward, gated, stage 4: the products the backward must do
    # (patch and window-weight gradients, centre terms once per point,
    # merge input and weight gradients), gathers and sums not counted
    n, c, cx, four_fin, two_f = stage_dims(4)
    case = head_bwd_case(4, B, True, gen, dev)
    args, idx, inte, cts = case
    x, _, wn, ca, pb, am, wen, pbm, pcat, ppoint, k, _ = args
    rows = B * n
    flops = (2 * 2.0 * rows * hk * window * c * four_fin
             + 2 * 2.0 * rows * c * four_fin
             + 2 * 2.0 * rows * K * c * two_f
             + 2 * 2.0 * rows * c * two_f)
    nbytes = 4.0 * (rows * c + rows * K + 2 * rows * hk * four_fin
                    + rows * two_f + 2 * four_fin
                    + (window + 1) * c * four_fin + (K + 1) * c * two_f
                    + 2 * rows * K * 16 + 2 * K * 32 + 2 * rows * 32
                    + rows * c + (window + 1) * c * four_fin
                    + (K + 1) * c * two_f + B * (four_fin + two_f)
                    + 2 * rows * 32)
    b, by = bound(flops, nbytes)
    kern = lambda: head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat,  # noqa: E731
                                   ppoint, cts, k)
    plain = lambda: head_bwd_plain(x, idx, wn, ca, pb, am, wen, pbm, pcat,  # noqa: E731
                                   ppoint, cts, k, window)
    res["edge_head_bwd"] = {
        "ms": time_ms(kern, 3), "plain_ms": time_ms(plain, 2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, C={c}+{cx}, gated"}
    res["edge_head_bwd"]["max_abs_err"] = compare_head_bwd(
        case, f"stage 4 B={B}")
    del case, args, idx, inte, cts, x

    # gated tail backward, stage 4
    targs = tail_inputs(4, B, True, gen, dev)
    dy = torch.randn(*targs[0].shape, generator=gen, device=dev)
    two_fin = four_fin // 2
    KK = hk * four_fin
    flops = (2 * 2.0 * rows * KK * two_f            # dg and d_wi
             + 3 * 2.0 * rows * K * 64 * two_fin   # conv_all2, d_h, d_w2k
             + 30.0 * rows * K * two_fin)          # gate, softmax, BN walk
    nbytes = 4.0 * (2 * rows * KK + 2 * rows * K * 64 + 2 * rows * two_f
                    + 2 * KK * two_f + 2 * 64 * two_fin + 4 * four_fin
                    + 6 * two_fin)
    b, by = bound(flops, nbytes)
    res["bilateral_tail_gated_bwd"] = {
        "ms": time_ms(lambda: tail_bwd_kernel(*targs[1:10], dy, K, True), 3),
        "plain_ms": time_ms(lambda: tail_bwd_plain(*targs[:11], dy, K, True),
                            2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, 4Fin={four_fin}, 2F={two_f}"}
    res["bilateral_tail_gated_bwd"]["max_abs_err"] = compare_tail_bwd(
        targs, dy, f"stage 4 B={B} gated")
    del targs, dy

    # plain tail backward, stage 1
    n1, _, _, four_fin1, two_f1 = stage_dims(1)
    targs = tail_inputs(1, B, False, gen, dev)
    dy = torch.randn(*targs[0].shape, generator=gen, device=dev)
    rows1 = B * n1
    flops = 2 * 2.0 * rows1 * hk * four_fin1 * two_f1 + 6.0 * rows1 * hk * four_fin1
    nbytes = 4.0 * (2 * rows1 * hk * four_fin1 + 2 * rows1 * two_f1
                    + 2 * hk * four_fin1 * two_f1 + 4 * four_fin1)
    b, by = bound(flops, nbytes)
    res["bilateral_tail_plain_bwd"] = {
        "ms": time_ms(lambda: tail_bwd_kernel(*targs[1:10], dy, K, True), 10),
        "plain_ms": time_ms(lambda: tail_bwd_plain(*targs[:11], dy, K, True),
                            10),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 1, B={B}, N={n1}, 4Fin={four_fin1}, 2F={two_f1}"}
    res["bilateral_tail_plain_bwd"]["max_abs_err"] = compare_tail_bwd(
        targs, dy, f"stage 1 B={B} plain")
    del targs, dy

    # local stats, the largest call of the step: 2048 points, 1024 centers
    M, N, kk = 1024, 2048, 20
    case = local_case(B, M, N, gen, dev)
    src, centers, g_mu, g_cov = case
    idx_k, mu_k, _ = fwd_kernel(src, centers, kk)
    # distances (3 sub, 3 mul, 2 add) and one compare per (center, point)
    b, by = bound(9.0 * B * M * N,
                  4.0 * (B * N * 3 + B * M * 3 + B * M * (3 + 9 + kk)))
    res["local_stats_fwd"] = {
        "ms": time_ms(lambda: fwd_kernel(src, centers, kk), 5),
        "plain_ms": time_ms(lambda: stats_given_idx(
            src, knn_direct(src, centers, kk).long()), 2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"B={B}, M={M} centers, N={N} points, k={kk}"}
    # per (center, slot): G y and alpha, ~24 FLOP
    b, by = bound(24.0 * B * M * kk,
                  4.0 * (B * N * 3 + B * M * kk + B * M * 15 + B * N * 3))
    res["local_stats_bwd"] = {
        "ms": time_ms(lambda: bwd_kernel(src, idx_k, mu_k, g_mu, g_cov), 10),
        "plain_ms": time_ms(lambda: bwd_plain(src, idx_k, g_mu, g_cov), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"B={B}, M={M} centers, N={N} points, k={kk}"}
    e_fwd, e_bwd = compare_local(case, f"M={M} N={N} B={B}")
    res["local_stats_fwd"]["max_abs_err"] = e_fwd
    res["local_stats_bwd"]["max_abs_err"] = e_bwd
    return res


KERNELS = {
    "edge_head": ("pdgn_tpu_torch/csrc/edge_head.cu",
                  "pdgn_tpu/ops/pallas/edge_head.py:74"),
    "slot_stats": ("pdgn_tpu_torch/csrc/slot_stats.cu",
                   "pdgn_tpu/ops/pallas/slot_stats.py:43"),
    "bilateral_tail_gated": ("pdgn_tpu_torch/csrc/bilateral_tail.cu",
                             "pdgn_tpu/ops/pallas/bilateral_tail.py:74"),
    "bilateral_tail_plain": ("pdgn_tpu_torch/csrc/bilateral_tail.cu",
                             "pdgn_tpu/ops/pallas/bilateral_tail.py:117"),
    "edge_head_bwd": ("pdgn_tpu_torch/csrc/edge_head_bwd.cu",
                      "pdgn_tpu/ops/pallas/edge_head.py:200"),
    "bilateral_tail_gated_bwd": ("pdgn_tpu_torch/csrc/bilateral_tail_bwd.cu",
                                 "pdgn_tpu/ops/pallas/bilateral_tail.py:135"),
    "bilateral_tail_plain_bwd": ("pdgn_tpu_torch/csrc/bilateral_tail_bwd.cu",
                                 "pdgn_tpu/ops/pallas/bilateral_tail.py:240"),
    "local_stats_fwd": ("pdgn_tpu_torch/csrc/local_stats.cu",
                        "pdgn_tpu/ops/pallas/local_stats.py:147"),
    "local_stats_bwd": ("pdgn_tpu_torch/csrc/local_stats.cu",
                        "pdgn_tpu/ops/pallas/local_stats.py:183"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pdgn_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(pdgn_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, root)

    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.utils.misc import resolve_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dev = resolve_device("cuda")   # also turns TF32 off
    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built and loaded in {build_s:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    log("phase 2: kernels against their plain versions (B=8)")
    errs = {
        "edge_head": max(
            compare_head(head_inputs(4, 8, True, gen, dev), "stage 4 B=8"),
            compare_head(head_inputs(1, 8, False, gen, dev), "stage 1 B=8")),
        "slot_stats": compare_slot_stats(
            torch.randn(8, stage_dims(4)[0], K * 64, generator=gen,
                        device=dev), "stage 4 B=8"),
        "bilateral_tail_gated": compare_tail(
            tail_inputs(4, 8, True, gen, dev), "stage 4 B=8 gated"),
        "bilateral_tail_plain": compare_tail(
            tail_inputs(1, 8, False, gen, dev), "stage 1 B=8 plain"),
    }

    log("phase 2t: train kernels against their plain versions (B=8)")
    errs.update(check_train_kernels(gen, dev))

    log("phase 3: main path, generate() at full width")
    path = main_path(dev)
    del path["model"]

    log(f"phase 3t: train path, PDGNTrainer.train at full width, "
        f"B={TRAIN_B}")
    train = train_path(root)

    log("phase 4: kernel times and checks at the main path's B=128 shapes")
    times = time_kernels(dev, gen)
    log(f"phase 4t: train kernel times and checks at B={TRAIN_B}")
    times.update(time_train_kernels(dev, gen))

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = times[name]
        by_path = {"sample": path["launches"].get(name, 0),
                   "train": train["launches"].get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": by_path["train"],
            "launches_by_path": by_path,
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        log(f"  {name} ({t['shape']}): {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), library {t['library_ms']}")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "kernels": kernels, "times": times, "path": path,
                       "train": train}, f, indent=1)
    print(json.dumps({"card": smi,
                      "clouds_per_s_b128": path["clouds_per_s"],
                      "train_steps_per_s_b35": train["steps_per_s"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
