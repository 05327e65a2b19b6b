#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pdgn_tpu_torch``) on one GPU.

Run from the root of the repository with no arguments::

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --train-alone     # phase 3t alone (below)
    python3 chip_smoke.py --parallel-alone  # phase 3m alone (below)

What it does, in order (any failure raises and the exit code is not 0):

1. prints the card (``nvidia-smi``), torch and CUDA versions, and builds
   the CUDA kernels from ``pdgn_tpu_torch/csrc`` (timed);
2. holds each kernel against its plain PyTorch version on the card, TF32
   off, at the generator's stage-4 shapes (B=8), plus stage 1 for the
   plain head and the plain tail. kNN indices may differ only at near-ties
   (every mismatched neighbour's distance within 1e-5 relative of the one
   it replaces, at most 0.1% of entries), and the head's graph equals
   ``knn_topk``'s; given the kernel's indices the head's other outputs are
   rel <= 1e-4; slot stats rel <= 1e-5; the tails rel <= 1e-4; a second
   launch of the head and of slot stats gives the same bits. ``rel`` is
   max |a - b| / max |b|. The head forward's outputs on numpy-drawn
   operands keep the digest they had before its product moved into the
   shared product core (``csrc/tf32x3_gemm.cuh``), and that core alone, at
   the long chains of the gated tail's merge (depth 5,120) and of the head
   backward (7,168, and a 35,840-row reduction in 4,096-row splits), is
   rel <= 1e-5 of float64 with its accumulators folded;
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
   SXM fp32 figures without tensor cores; the products that the head, the
   tails and their backwards run on the tensor cores at 3xTF32's 495 / 3
   TFLOP/s); holds each kernel's B=128 outputs against its
   plain version's with phase 2's tolerances and near-tie rule; and
   prints the gated tail's merge product alone (the shared core) against
   ``torch.addmm`` in fp32, a yardstick the port never calls.

The train slice, in the same phases:

2t. the backward kernels and the local-stats kernels against their plain
   versions at stage-4 shapes, B=8: the head's and the tails' gradients rel
   <= 1e-4 given the same graph and the same random cotangents, except
   where fp32 is worse conditioned than that (the gated tail's d h, d w2k,
   d w2b, d s2, d t2 through the slot softmax: the plain version is 2e-4
   to 1.2e-2 off its own float64 evaluation at these shapes); there the
   kernel's error against float64 is at most twice the plain version's;
   the g that the tail backward's gate pass writes (for d_wi = g^T dy)
   equal to the forward gate's under ``torch.equal``;
   ``local_mean_cov`` forward with neighbour sets equal except at near-ties
   (PR 1's rule), mu and cov rel <= 1e-4 over the centers whose sets agree,
   its residual (theta, the k-th distance, and tie, the k-th index) equal
   to ``residual_plain``'s and rebuilding every center's set exactly, its
   backward from that residual rel <= 1e-4 of ``bwd_plain`` given the same
   selection;
3t. drives the train path through the trainer's entry point
   (``PDGNTrainer.train``, what ``--phase train`` runs) at full width,
   B=35, synthetic data: 21 steps (one warm-up, twenty timed) with every
   launch counter set to 0 just before and read just after. Checks the six
   losses are finite, every G and D parameter has a finite gradient, the G
   parameters moved, the launch counts per step (head 8 forward and 4
   backward, slot stats 6, gated tail 6 and 3, plain tail 2 and 1, local
   stats 9 and 9), and that both checkpoint bundles were written and load
   back; prints train steps/s at B=35 over the trainer's step span and
   over each step's start to the next (the batch's production, copy and
   wait included). ``--train-alone`` builds the kernels and runs this
   phase alone; copied into another checkout's root, the script times
   that checkout's trainer the same way;
4t. times each train kernel at the train path's B=35 shapes beside its plain
   version and its bound, and holds its outputs to phase 2t's tolerances;
   ``local_mean_cov``'s forward and backward at all 9 calls of a train
   step (the shape loss's 3 self and 6 cross pairs over clouds of 256-2048
   points), each selection equal to the plain one, mu and cov rel <= 1e-4,
   the residual as in 2t, d_src rel <= 1e-4 of ``bwd_plain``; their times
   and bounds the sums over the 9 (the backward's device time with its
   launches queued back to back; its largest call also timed unqueued, the
   earlier measure); prints the head backward's input-gradient product alone
   (Gc @ W_conv on the shared core) against ``torch.addmm`` in fp32.
   Phase 2t also prints the fp32 head and tail backwards' digest on
   numpy-drawn operands (``compare_head_bits.bwd_digest``) and requires it
   to equal ``compare_head_bits.BWD_BITS``, the digest of those kernels
   before their bf16 instances were added.

The test slice, in the same phases:

2e. the fused CD + approxmatch kernel (``emd_cd``) against its plain
   version (``chamfer_cd`` + ``match_cost`` over the pairs) on every pair
   of a 2-cloud and a 4-cloud set at n = 2048 (bbox-normalised synthetic
   shapes against shape_unit ones, as the test phase pairs them): cd rel
   <= 1e-5, cost rel <= 2e-3 (distances by direct differences against the
   norm expansion: at level -4^7 an ulp of d2 moves K by ~2e-3, the JAX
   package's own limit); a second launch bit-identical and equal to a
   launch that culls nothing (the culled share of the culling tests is
   printed); a set against itself cd = 0 and cost/n < 1e-3 on the
   diagonal; then a 2 x 2 set at n = 8192 (beyond one block's shared
   memory) with the same tolerances;
3e. drives the test path through the trainer's entry point
   (``PDGNTrainer.test(tile=64)``, what ``--phase test`` runs) at full
   width on 64 synthetic 2048-point clouds, loading the bundles phase 3t
   wrote (3t's clean-up runs after 3e), with every launch counter set to 0
   just before and read just after: three 64x64 matrices, one emd_cd
   launch each, and two generator forwards at B=35; every metric finite.
   Recomputes the three matrices (timed: CD+EMD pairs/s, and from it the
   estimated full chair evaluation, 3 x 662^2 pairs, on this card), checks
   their MMD/COV equal the phase's results and holds each one's 8x8 corner
   against the plain version; then runs ``python -m pdgn_tpu_torch.cli
   --phase test --dataset synthetic`` on the same bundles, in a process of
   its own (the script's one run of the module entry: 3bt and 3d call
   ``cli.main`` in process);
4e. times the kernel on one 64x64 and one 8x8 tile beside its bound
   (max of 80 FLOP an element at 67 TFLOP/s and three expf an element at
   16 per SM per clock), the 64x64 tile again with culling off, and the
   plain version on an 8x8 tile and, in 8x8 blocks, on the 64x64 tile's
   pairs; prints the time of the 2 x 2 set at n = 8192.

The data slice, after 3e:

3d. writes a shapenet15k-layout file under ``pdgn_tpu_torch/_build/``
   (``tests/torch_h5_fixture.py``, no h5py: chair 175/8/64 clouds, airplane
   4/2/4, 2048 points from a seed; chair's train split contiguous, its test
   split chunked 5 clouds a chunk through shuffle and deflate, the last
   chunk ragged) and reads every dataset back through
   ``pdgn_tpu_torch.data.h5`` (``np.array_equal``); checks that
   ``train_loader(ShapeNetCore(..., "chair", "train", "shape_unit"), 35)``
   yields the host ``batch_iterator``'s batches on the same numpy seed;
   times the loader over one epoch of 130 batches (a second file, 4,550
   chairs) alone (batches/s, the first batch's latency) and, over the
   first 33 batches of an epoch, under a 20 ms stand-in step (a device
   sleep, synchronised each step as the trainer's metrics are) against a
   plain synchronous copy in the consumer after the same threaded host
   prefetch (pinned, plain, plain, pinned); runs
   ``cli.main([... '--phase', 'train', '--dataset', 'shapenet15k',
   '--choice', 'chair', '--batch_size', '35', '--max_epoch', '1',
   '--profile_dir', P])`` at full width with every launch counter set to 0
   just before and read just after (``PER_STEP`` a step, 5 steps, finite
   losses, a trace under P, the sources copied); writes the trained state
   as ``.msgpack`` bundles and reloads them into a fresh state (every
   parameter, buffer, Adam moment and step ``torch.equal``); resumes from
   them with ``--max_epoch 2`` (10 steps, ``PER_STEP`` each, none under
   the profiler) and prints the share of their step wall time the consumer
   waited on the loader, with and without each epoch's first batch; runs
   ``--phase test --dataset shapenet15k --choice chair`` on the bundles
   (``out.npy`` (64, 2048, 3), the 13 metric lines finite); deletes the
   files.

The point-ops slice, in the same phases:

2p. ``knn_topk`` and ``knn_gather`` against their plain versions at B=8:
   C in {3, 256}, k in {20, 64, 128}, queries other than the database, and
   self queries on clouds whose every point appears twice (each row's pair
   first, in order); indices equal for C <= 4 (the kernel rounds as the
   plain version does) and otherwise equal but at near-ties (phase 2's
   rule); ``knn_gather`` at C=128, k=10: nbr bit-equal to
   ``grouping(x, idx)``, the gradient of sum(nbr^2) rel <= 1e-5; and the
   stage-4 head's graph input (1024 points, C = 128 + 128 with the xs half
   constant over a cloud), k=11;
3p. drives the public ``pdgn_tpu_torch.ops`` API at full width on 35
   clouds from ``generate()`` (FPS, grouping, ball query, dilated groups,
   interpolation, edge features, ``neighbor_features``, ``EdgeConv``
   forward and backward) with every launch counter set to 0 just before
   and read just after (6 ``knn_topk``, 1 ``knn_gather``), then holds each
   kernel graph of the path against its plain version and prints the
   path's wall time (the median of 5 warm passes; the first, counted
   pass is printed too, cold);
4p. times ``knn_topk`` at the path's three shapes, at the stage-4 head's
   graph input at B=128, and ``knn_gather`` beside the plain version,
   ``torch.cdist`` + ``torch.topk`` (two calls, a yardstick) and the bound.

The widened shapes (the card path's limits beyond the default model),
after 2p:

2w. the head, its backward and the gated tail with its backward at stage
   4, B=8, k = 14 and 18 (``--num_k`` 28 and 36); the plain head with 4Fin
   and 2F no multiples of 4; the gated and plain tail with its backward at
   4Fin = 130, 2F = 66 (odd 2Fin); ``local_mean_cov`` at k=24 over 20,000
   points; each against its plain version with phase 2's and 2t's
   tolerances and timed once (one line each; their speed is not a goal);
   then ``generate()`` at full width with num_k 28 and 36 (launch counters
   set to 0 just before and read just after, each stage held to the plain
   CPU path's outputs as in phase 3) and its clouds/s at B=32.

The bf16 slice (``--compute_dtype bfloat16``: the bf16 instances of the
head, slot stats and both forward tails), after 2w, 3, 3e and 4p:

2b. each bf16 instance against its bf16 plain version at stage 4, B=8
   (the plain head and tail at stage 1), at k = 14 and 18 and at 4Fin =
   130, 2F = 66: bf16 outputs within ``BF16_ULPS`` (2 ulps of the larger
   magnitude, counted at no less than 1/256 of the tensor's largest), fp32
   outputs rel <= 1e-4 (slot stats 1e-5), the graph equal to
   ``knn_topk``'s on the fp32 upcast and to the plain one's but at
   near-ties (phase 2's rule); two launches bit-identical;
3b. ``generate()`` in bf16 at full width, 256 clouds in batches of 128, on
   phase 3's weights: launch counters set to 0 just before and read just
   after (the bf16 instances only: 4 head, 3 slot-stats, 3 gated and 1
   plain tail a forward), fp32 finite clouds, each stage held to the
   plain CPU bf16 path's (rel <= 2e-2, graphs equal but at near-ties;
   the share of ec's entries that differ printed), their matched Chamfer
   distance to phase 3's fp32 clouds from the same noise beside the one
   between fp32 clouds from other noise, and clouds/s for the record;
3be. ``PDGNTrainer.test`` with compute_dtype bfloat16 on 64 synthetic
   clouds (seeded weights): the bf16 instances and ``emd_cd``, 13 finite
   metrics;
4b. each bf16 instance at B=128 (stage 4; the plain tail at stage 1): its
   time, its bf16 plain version's, the library call where one computes
   the same function (``h.T @ h`` in bf16 for slot stats; ``torch.addmm``
   in bf16 as the merge's sub-yardstick), the bound (products at the bf16
   tensor cores' 989 TFLOP/s), and the 2b checks again.

The bf16 train slice (``--phase train --compute_dtype bfloat16``: the
bf16 instances of the head backward and both tail backwards), after 2b,
3be and 4b:

2bt. each bf16 backward instance against its bf16 plain version (the TPU
   kernels' rounding points, ``head_bwd_plain_bf16``,
   ``tail_bwd_plain_bf16``) at stage 4 and stage 1, B=35, and at phase
   2w's k = 14 and 18 (B=8), with cotangents as bf16 training gives them:
   bf16 outputs within ``BF16_ULPS``, fp32 outputs rel <= 1e-4, two
   launches bit-identical. The gated tail's slot-logit entries at a kink
   (``kink_mask``: each side takes LeakyReLU's branch from its own fp32
   sum) are counted and printed, and d h is held on the rows free of them;
3bt. ``PDGNTrainer.train`` with compute_dtype bfloat16 at full width,
   B=35, synthetic, 21 steps (one warm-up, twenty timed), counters set to 0
   just before and read just after: only the bf16 instances of the head,
   slot stats and both tails, forward and backward (``BF16_PER_STEP``),
   and the fp32 local statistics of the shape loss; finite losses, finite
   fp32 gradients, the generator moved; train steps/s printed as a
   reading. Then 3 steps with ``d_compute_dtype="bfloat16"`` too (finite)
   and ``cli.main([... '--phase', 'train', '--compute_dtype', 'bfloat16',
   '--dataset', 'synthetic'])`` (``python -m pdgn_tpu_torch``'s entry, in
   process as 3d drives it) for 3 steps;
4bt. each bf16 backward instance at B=35 (stage 4; the plain tail stage
   1): its time, its bf16 plain version's and its bound (products at the
   bf16 tensor cores' 989 TFLOP/s), and the 2bt checks again.

The data-parallel slice (``pdgn_tpu_torch.parallel``), after 3p:

3m. (1) ``PDGNTrainer.train`` at full width, B=35, synthetic, 3 steps and
   then ``PDGNTrainer.test``, once without a group and once as the one rank
   of an NCCL group (``tcp://localhost``): each step's six metrics and the
   test results equal bit for bit, the launches of each run equal
   ``PER_STEP`` a step, and the collectives a step, their bytes and both
   runs' step seconds are printed on a JSON line beside the card's name
   and power limit; (2) two ranks on the one card over gloo (NCCL takes
   one rank a card), spawned after the kernels are built: ``generate()``
   of 70 clouds (a batch each) and the pairwise rows of 70 x 70 clouds in
   tiles of 32 equal one process's exactly, and the first train step at
   B=35 (18 + 17 rows) gives one process's d_loss1-4 and similar_loss
   within rel 1e-3 and its g_loss within rel 1e-3 unless a generator
   forward's kNN graphs (D noise or G noise) differ from one process's at
   a near-tie, with ``PER_STEP`` launches on each rank.

The native oracles (``pdgn_tpu_torch.native``: the reference kernels'
algorithms in scalar C++ on the host, independent of the port's torch
code), after phase 2:

2n. builds the native library with g++ (timed) and, with the card's
   results copied to the host explicitly: ``knn_topk`` on the card (4
   clouds of 2048 points, self queries, k = 20) against ``knnquery_cpu``,
   indices equal but at near-ties by phase 2's rule; ``emd_cd`` on the
   card over 2 x 2 test-path clouds of 2048 points against
   ``nndistance_cpu`` (CD = mean(dl) + mean(dr), rel <= 1e-5) and
   ``approxmatch_cpu`` (cost rel <= 2e-3, the kernel's limit against its
   plain version), ``emd_cd_plain``'s gaps to the same oracle printed
   beside them; ``ops.furthest_point_sample`` on the card (4 clouds, 2048
   -> 512) against ``fps_cpu``, indices equal (the first differing pick
   named otherwise). One JSON line holds the gaps, the host seconds, the
   host CPU's model name and the card's name and power limit.

In phase 3d, after the 5-step train: ``python -m
pdgn_tpu_torch.convert_ckpt`` in a process of its own turns the trainer's
``1_chair_{G,D}.pth`` into msgpack bundles, and ``--phase test`` from that
pair and from the ``.pth`` pair each give the 13 metric lines, ``out.npy``
and the launches of the counted test run bit for bit (those two runs'
launches are not added to the path's).

Last, it prints the ``{"kernels": [...]}`` line (``launches`` summed over
the sample, train, test, data, point-ops, bf16 sample, bf16 test, bf16
train and data-parallel runs, ``launches_by_path`` each), then the
``{"ok": ...}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

PEAK_FLOPS = 67e12       # H100 SXM fp32, no tensor cores (data sheet)
PEAK_TF32X3 = 495e12 / 3  # dense TF32 (data sheet), three passes a product
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


def queued_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` with its launches queued behind a sleeping
    kernel, so the card runs them back to back: device time, without the
    gaps of host calls slower than the kernels they launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ~25 ms at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ inputs
def head_inputs(stage: int, B: int, gated: bool, gen, dev, k: int = K):
    """Prepared operands of the edge head at a stage's full-width shapes,
    from seeded random features and weights."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import head_operands

    n, c, cx, four_fin, two_f = stage_dims(stage)
    cf = c + cx
    window = k // 2 + 1

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x = r(B, n, c)
    xs = r(B, cx) if cx else None
    conv_kernel = r(1, window, 2 * cf, four_fin,
                    scale=(2 * cf * window) ** -0.5)
    conv_bias = r(four_fin, scale=0.1)
    merge_kernel = r(2 * k * 2 * cf, two_f, scale=(4 * k * cf) ** -0.5)
    ops = head_operands(x, conv_kernel, conv_bias, merge_kernel, k, xs)
    pcat = r(B, n, 32) if gated else None
    ppoint = r(B, n, 32) if gated else None
    x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, window = ops
    return (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
            pcat, ppoint, k, window)


def tail_inputs(stage: int, B: int, gated: bool, gen, dev, k: int = K):
    import torch

    n, _, _, four_fin, two_f = stage_dims(stage)
    hk = k // 2
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
                bias, k, True)
    h = r(B, n, k * 64, scale=0.5)
    w2k = r(64, two_fin, scale=0.125)
    w2b = r(two_fin, scale=0.1)
    s2 = r(two_fin, scale=0.2, shift=1.0)
    t2 = r(two_fin, scale=0.1)
    return (partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias, k, True)


# ------------------------------------------------------- kernel vs plain
def compare_head(args, label: str) -> float:
    """The edge head's kernel against its plain version on ``args``: two
    launches bit-identical, the graph equal to ``knn_topk``'s (k+1, slot 0
    dropped) and to the plain one's except at near-ties, the other outputs
    (given the kernel's indices) rel <= 1e-4. Returns the largest absolute
    error."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                      head_reference_given_idx)
    from pdgn_tpu_torch.ops.kernels.knn import knn_topk
    from pdgn_tpu_torch.ops.knn import knn_exclude_first
    from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

    (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, pcat,
     ppoint, k, window) = args
    names = ("inte", "partial", "stats", "wfea", "wxyz", "wstats")
    got = edge_head(*args)
    again = edge_head(*args)
    torch.cuda.synchronize()
    idx_k = got[0]
    for name, a, b in zip(("idx",) + names, got, again):
        require(a is None or torch.equal(a, b),
                f"head {label}: {name} differs between two launches")
    require(torch.equal(idx_k, knn_topk(x_knn, x_knn, k + 1)[..., 1:]),
            f"head {label}: the graph is not knn_topk's")
    del again
    idx_p = knn_exclude_first(self_pairwise_sqdist(x_knn), k)
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
    """Slot stats' kernel against its plain version: rel <= 1e-5; two
    launches bit-identical."""
    import torch
    from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                       stats_plain)

    s_k, S_k = slot_moment_stats(h, K)
    s_2, S_2 = slot_moment_stats(h, K)
    require(torch.equal(s_k, s_2) and torch.equal(S_k, S_2),
            f"slot_stats {label}: two launches differ")
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


def check_core(gen, dev) -> dict:
    """The shared product core alone at the long chains of the gated tail's
    merge (depth 5,120) and the head backward (Gc @ W_conv, 7,168; x^T Gc
    over the 35,840 rows of B=35 in 4,096-row splits): folded as the port
    runs it, rel <= 1e-5 of float64."""
    import torch
    from pdgn_tpu_torch.ops.kernels.tc_gemm import tc_matmul

    out = {}
    for what, rows, depth, cols, trans in (
            ("tail merge", 1024, 5120, 512, False),
            ("head bwd Gc @ W_conv", 1024, 7168, 128, False),
            ("head bwd x^T Gc", 128, 35840, 1024, True)):
        a = torch.randn(*((depth, rows) if trans else (rows, depth)),
                        generator=gen, device=dev)
        b = torch.randn(depth, cols, generator=gen, device=dev)
        b *= depth ** -0.5
        want = (a.double().T if trans else a.double()) @ b.double()
        e = rel(tc_matmul(a, b, trans=trans), want)
        log(f"  core {what}, depth {depth}: rel {e:.3e}")
        require(e <= 1e-5, f"core {what}: rel {e}")
        out[what] = e
    return out


# ------------------------------------------------------------ phase 3: path
def stage_check(model, dev, tol: float = 1e-3) -> dict:
    """Feed each stage on the card the inputs the plain CPU path gave it;
    stage outputs rel <= ``tol`` where the kNN rows agree."""
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
                d = self_pairwise_sqdist(
                    x.double() if x.dtype == torch.bfloat16 else x)
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
            if want[2].dtype == torch.bfloat16:
                frac = float((got[2].cpu()[keep2] != want[2][keep2])
                             .float().mean())
                log(f"  {name}: bf16 ec entries differing {frac:.5f}")
            idx_diff = float(mism.float().mean())
            log(f"  {name}: stage outputs rel {max(errs):.3e} "
                f"(points with other neighbour lists left out: "
                f"{int((~keep).sum())}), graph entries differing "
                f"{idx_diff:.6f}, max near-tie gap {gap:.3e}")
            require(max(errs) <= tol, f"{name}: stage outputs rel "
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
def bound(flops: float, nbytes: float, t_ops: float = 0.0):
    """The least time (ms) and what sets it: ``flops`` at the fp32 SIMT rate
    plus ``t_ops`` ms of work counted at other rates, against ``nbytes``."""
    t_ops += flops / PEAK_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def product_yardstick(what: str, a, b, addend) -> dict:
    """The shared product core alone (``tc_matmul``: ``addend + a @ b``,
    folded 3xTF32) against ``torch.addmm(addend, a, b)`` in fp32 (TF32 off)
    on the same operands: times, rates and their difference."""
    import torch
    from pdgn_tpu_torch.ops.kernels.tc_gemm import tc_matmul

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    got = tc_matmul(a, b, addend)
    want = torch.addmm(addend, a, b)
    e = rel(got, want)
    del got, want
    ms = time_ms(lambda: tc_matmul(a, b, addend), 3)
    lib = time_ms(lambda: torch.addmm(addend, a, b), 3)
    flop = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    log(f"  sub-yardstick {what} {tuple(a.shape)} @ {tuple(b.shape)}: "
        f"core {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s), torch.addmm "
        f"fp32 {lib:.3f} ms ({flop / lib / 1e9:.1f} TFLOP/s), rel {e:.3e}")
    require(e <= 1e-5, f"{what}: the core is {e} off torch.addmm")
    return {"what": what, "shape": f"{tuple(a.shape)} @ {tuple(b.shape)}",
            "ms": ms, "addmm_ms": lib, "rel": e}


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
    # the least work: x[idx] W = (x W)[idx], so one product of every point
    # with the 7 window blocks and the k+1 merge blocks, at 3xTF32's
    # fp32-accurate tensor-core rate; kNN distances (the xs half is the same
    # for every point of a cloud and drops out of the ranking) and the
    # gather adds at the fp32 SIMT rate
    products = 2.0 * rows * c * ((window + 1) * four_fin + (K + 1) * two_f)
    simt = (2.0 * B * n * n * c                          # kNN distances
            + 1.0 * rows * hk * window * four_fin        # window sums
            + 1.0 * rows * K * two_f                     # merge sums
            + 1.0 * rows * K * 32)                       # weight-net rows
    t_ops = (products / PEAK_TF32X3 + simt / PEAK_FLOPS) * 1e3
    nbytes = 4.0 * (rows * c + B * cx + rows * 64        # x, xs, pcat+ppoint
                    + (window + 1) * c * four_fin + (K + 1) * c * two_f
                    + B * (four_fin + two_f)             # weights, biases
                    + rows * K                           # idx
                    + rows * hk * four_fin + rows * two_f + 2 * four_fin
                    + rows * K * 32 + 2 * K * 32)        # outputs
    b, by = bound(0.0, nbytes, t_ops)
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

    # gated tail, stage 4: both products (conv_all2, the merge) on the
    # tensor cores at 3xTF32's rate; BN folds, LeakyReLUs, the softmax, the
    # gate and the merge's addend and bias at the fp32 SIMT rate
    targs = tail_inputs(4, B, True, gen, dev)
    two_fin = four_fin // 2
    products = (2.0 * rows * K * 64 * two_fin            # conv_all2
                + 2.0 * rows * hk * four_fin * two_f)    # merge
    simt = 8.0 * rows * K * two_fin + 2.0 * rows * two_f
    nbytes = 4.0 * (rows * two_f * 2 + rows * hk * four_fin + rows * K * 64
                    + hk * four_fin * two_f + 64 * two_fin + 2 * four_fin)
    b, by = bound(simt, nbytes, products / PEAK_TF32X3 * 1e3)
    res["bilateral_tail_gated"] = {
        "ms": time_ms(lambda: tail(*targs), 3),
        "plain_ms": time_ms(lambda: tail_reference(*targs), 3),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, 4Fin={four_fin}, 2F={two_f}"}
    res["bilateral_tail_gated"]["max_abs_err"] = compare_tail(
        targs, f"stage 4 B={B} gated")
    partial, wi = targs[0].reshape(rows, two_f), targs[9]
    del targs
    # the merge product alone against cuBLAS's fp32 SGEMM (TF32 off): a
    # yardstick for one product of the kernel, never called by the port
    g = torch.randn(rows, hk * four_fin, generator=gen, device=dev)
    res["bilateral_tail_gated"]["sub_yardstick"] = product_yardstick(
        "merge g @ wi + partial", g, wi, partial)
    del g, partial, wi

    # plain tail, stage 1
    n1, _, _, four_fin1, two_f1 = stage_dims(1)
    targs = tail_inputs(1, B, False, gen, dev)
    rows1 = B * n1
    # its merge runs on the tensor cores too
    products = 2.0 * rows1 * hk * four_fin1 * two_f1
    nbytes = 4.0 * (rows1 * two_f1 * 2 + rows1 * hk * four_fin1
                    + hk * four_fin1 * two_f1 + 2 * four_fin1)
    b, by = bound(3.0 * rows1 * hk * four_fin1 + 2.0 * rows1 * two_f1, nbytes,
                  products / PEAK_TF32X3 * 1e3)
    res["bilateral_tail_plain"] = {
        "ms": time_ms(lambda: tail(*targs), 10),
        "plain_ms": time_ms(lambda: tail_reference(*targs), 10),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 1, B={B}, N={n1}, 4Fin={four_fin1}, 2F={two_f1}"}
    res["bilateral_tail_plain"]["max_abs_err"] = compare_tail(
        targs, f"stage 1 B={B} plain")
    return res


# ----------------------------------------------- the train slice: phase 2t
def head_bwd_case(stage: int, B: int, gated: bool, gen, dev, k: int = K):
    """Operands, the kernel's graph and forward, and random cotangents of
    the head at a stage's full-width shapes."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import edge_head

    args = head_inputs(stage, B, gated, gen, dev, k)
    idx, inte = edge_head(*args)[:2]
    n, _, _, four_fin, two_f = stage_dims(stage)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cts = [r(*inte.shape), r(B, n, two_f), r(2, four_fin, scale=0.01)]
    if gated:
        cts += [r(B, n, k * 16), r(B, n, k * 16), r(2, k * 32, scale=0.01)]
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
    """The tail backward's gradients as ``compare_grads`` holds them, and
    the g its gate pass writes (for d_wi = g^T dy) equal to the forward
    gate's g under ``torch.equal``."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail_bwd_kernel,
                                                           tail_bwd_plain,
                                                           tail_kernel)

    k, softmax = args[11], args[12]
    *got, g_bwd = tail_bwd_kernel(*args[1:10], dy, k, softmax, keep_g=True)
    g_fwd = tail_kernel(*args, keep_g=True)[1]
    require(torch.equal(g_bwd, g_fwd),
            f"tail bwd {label}: the backward's g is not the forward's")
    log(f"  tail bwd {label}: g equal to the forward's (torch.equal)")
    del g_bwd, g_fwd
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


def check_residual(src, centers, k, idx, theta, tie, label: str) -> None:
    """The forward kernel's residual equal to ``residual_plain``'s on the
    kernel's indices (``torch.equal``), and rebuilding each center's set
    exactly: ``d < theta | (d == theta & j <= tie)`` selects the k points
    of ``idx`` and no other."""
    import torch
    from pdgn_tpu_torch.ops.kernels.local_stats import (residual_plain,
                                                        selection_mask)

    theta_p, tie_p = residual_plain(src, centers, idx)
    require(torch.equal(theta, theta_p) and torch.equal(tie, tie_p),
            f"local stats {label}: the residual differs from the plain one")
    mask = selection_mask(src, centers, theta, tie)
    want = torch.zeros_like(mask).scatter_(-1, idx.long(), True)
    require(torch.equal(mask, want),
            f"local stats {label}: the residual does not rebuild the set")
    del mask, want


def compare_local(case, label: str, k: int = 20):
    """Forward: neighbour sets equal except at near-ties (at most 0.1% of
    the centers, each mismatched neighbour within 1e-5 relative distance of
    the one it replaces); mu and cov rel <= 1e-4 over the centers whose sets
    agree; the residual as ``check_residual`` holds it. Backward from the
    residual rel <= 1e-4 of ``bwd_plain`` given the kernel's selection.
    Returns the largest absolute errors of the forward and the backward."""
    import torch
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel,
                                                        bwd_plain,
                                                        fwd_kernel,
                                                        knn_direct,
                                                        stats_given_idx)

    src, centers, g_mu, g_cov = case
    idx_k, theta, tie, mu, cov = fwd_kernel(src, centers, k)
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
    check_residual(src, centers, k, idx_k, theta, tie, label)
    keep = ~differ
    mu_p, cov_p = stats_given_idx(src, idx_p.long())
    e_mu = rel(mu[keep], mu_p[keep])
    e_cov = rel(cov[keep], cov_p[keep])
    d_k = bwd_kernel(src, centers, theta, tie, mu, g_mu, g_cov, k)
    d_p = bwd_plain(src, idx_k, g_mu, g_cov)
    e_b = rel(d_k, d_p)
    log(f"  local_stats {label}: sets differ at {frac:.6f} of the centers "
        f"(max near-tie gap {gap:.3e}), residual equal to the plain one and "
        f"rebuilding every set, mu rel {e_mu:.3e}, cov rel {e_cov:.3e}, "
        f"d_src rel {e_b:.3e}")
    require(e_mu <= 1e-4 and e_cov <= 1e-4, f"local stats {label} fwd")
    require(e_b <= 1e-4, f"local stats {label} bwd: {e_b}")
    return (max(max_abs(mu[keep], mu_p[keep]), max_abs(cov[keep], cov_p[keep])),
            max_abs(d_k, d_p))


# the shape loss's local_mean_cov calls of one train step, (M centers, N
# points): its clouds of 256, 512, 1024 and 2048 points, 3 self pairs and 6
# coarse-fine pairs (losses/shape_preserving.py)
SHAPE_LOSS_CALLS = ((256, 256), (512, 512), (1024, 1024), (256, 512),
                    (256, 1024), (256, 2048), (512, 1024), (512, 2048),
                    (1024, 2048))


def shape_loss_clouds(B: int, gen, dev) -> dict:
    """The four clouds of one step's shape loss, each finer one around the
    one before (every point twice, jittered), as the generator's stages
    refine them."""
    import torch

    clouds = {256: torch.randn(B, 256, 3, generator=gen, device=dev)}
    for n in (512, 1024, 2048):
        prev = clouds[n // 2]
        clouds[n] = (prev.repeat_interleave(2, dim=1) + 0.02 * torch.randn(
            B, n, 3, generator=gen, device=dev)).contiguous()
    return clouds


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


# ------------------------------------------ the widened shapes: phase 2w
WIDE_K = (14, 18)        # the head's and tails' k at --num_k 28 and 36
WIDE_B = 32              # clouds a batch of the widened generators' runs


def odd_head_inputs(B: int, gen, dev):
    """The plain stage-1 head with 4Fin = 130 and 2F = 66 (no multiples of
    4: the gather pass takes scalar columns)."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import head_operands

    n, c = 128, 32
    window = K // 2 + 1

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x = r(B, n, c)
    ops = head_operands(x, r(1, window, 2 * c, 130, scale=0.05),
                        r(130, scale=0.1), r(2 * K * 2 * c, 66, scale=0.03),
                        K)
    x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, window = ops
    return (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge,
            None, None, K, window)


def odd_tail_inputs(B: int, gated: bool, gen, dev):
    """A tail at stage 1's 128 points with 4Fin = 130 and 2F = 66: 2Fin =
    65 is odd, and every operand of the backward's products is padded."""
    import torch

    n, four_fin, two_f = 128, 130, 66
    hk, two_fin = K // 2, four_fin // 2

    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    return (r(B, n, two_f), r(B, n, hk * four_fin),
            r(B, n, K * 64, scale=0.5) if gated else None,
            r(four_fin, scale=0.2, shift=1.0), r(four_fin, scale=0.1),
            r(64, two_fin, scale=0.125) if gated else None,
            r(two_fin, scale=0.1) if gated else None,
            r(two_fin, scale=0.2, shift=1.0) if gated else None,
            r(two_fin, scale=0.1) if gated else None,
            r(hk * four_fin, two_f, scale=(hk * four_fin) ** -0.5),
            r(two_f, scale=0.1), K, True)


def check_wide_shapes(gen, dev) -> dict:
    """Phase 2w: the shapes the kernels took since they were widened, each
    against its plain version with phase 2's and 2t's tolerances and timed
    once (their speed is not a goal): the head, its backward and the gated
    tail with its backward at stage 4, B=8, k in WIDE_K (k=18 takes the
    tail's run-time-k gate); the plain head with 4Fin and 2F off float4;
    the gated and plain tail with its backward at 4Fin = 130, 2F = 66;
    ``local_mean_cov`` at k=24 over 20,000 points (the run-time-k kNN, the
    points streamed through shared memory); then ``generate()`` at full
    width with num_k 28 and 36, launch counters set to 0 just before and
    read just after, and each stage held to the plain CPU path's outputs
    as in phase 3."""
    import numpy as np
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (tail,
                                                           tail_bwd_kernel)
    from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                      head_bwd_kernel)
    from pdgn_tpu_torch.ops.kernels.local_stats import fwd_kernel
    from pdgn_tpu_torch.train.generate import build_generator, generate

    out = {"times_ms": {}, "generate": {}}
    times = out["times_ms"]

    def timed(label, fn, reps):
        times[label] = time_ms(fn, reps)
        log(f"  time {label}: {times[label]:.3f} ms")

    for k in WIDE_K:
        args = head_inputs(4, 8, True, gen, dev, k)
        compare_head(args, f"stage 4 B=8 k={k}")
        timed(f"edge_head stage 4 B=8 gated k={k}", lambda: edge_head(*args),
              3)
        case = head_bwd_case(4, 8, True, gen, dev, k)
        compare_head_bwd(case, f"stage 4 B=8 k={k}")
        (x, _, wn, ca, _, am, wen, _, pcat, ppoint, _, _), idx, inte, cts = case
        timed(f"edge_head_bwd stage 4 B=8 gated k={k}",
              lambda: head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat,
                                      ppoint, cts, k), 3)
        del args, case, x, idx, inte, cts
        targs = tail_inputs(4, 8, True, gen, dev, k)
        compare_tail(targs, f"stage 4 B=8 gated k={k}")
        timed(f"bilateral_tail_gated stage 4 B=8 k={k}",
              lambda: tail(*targs), 3)
        dy = torch.randn(*targs[0].shape, generator=gen, device=dev)
        compare_tail_bwd(targs, dy, f"stage 4 B=8 k={k}")
        timed(f"bilateral_tail_gated_bwd stage 4 B=8 k={k}",
              lambda: tail_bwd_kernel(*targs[1:10], dy, k, True), 3)
        del targs, dy

    args = odd_head_inputs(8, gen, dev)
    compare_head(args, "stage 1 B=8 4Fin=130 2F=66 (scalar columns)")
    timed("edge_head stage 1 B=8 4Fin=130 2F=66", lambda: edge_head(*args),
          5)
    del args
    for gated in (True, False):
        label = f"B=8 4Fin=130 2F=66 {'gated' if gated else 'plain'}"
        targs = odd_tail_inputs(8, gated, gen, dev)
        compare_tail(targs, label)
        dy = torch.randn(*targs[0].shape, generator=gen, device=dev)
        compare_tail_bwd(targs, dy, label)
        timed(f"bilateral_tail_{'gated' if gated else 'plain'}_bwd {label}",
              lambda: tail_bwd_kernel(*targs[1:10], dy, K, True), 5)
        del targs, dy

    case = local_case(2, 2048, 20000, gen, dev)
    compare_local(case, "k=24 M=2048 N=20000 B=2", k=24)
    timed("local_stats_fwd k=24 M=2048 N=20000 B=2",
          lambda: fwd_kernel(case[0], case[1], 24), 5)
    del case

    for num_k in (2 * k for k in WIDE_K):
        model = build_generator(SEED, dev, num_k=num_k)
        torch.cuda.synchronize()
        _lib.LAUNCHES.clear()
        clouds = generate(WIDE_B, WIDE_B, SEED, device=dev, model=model)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        log(f"  generate({WIDE_B}, B={WIDE_B}) at num_k {num_k}: launches "
            f"{launches}")
        require(clouds.shape == (WIDE_B, 2048, 3)
                and bool(np.isfinite(clouds).all()),
                f"num_k {num_k}: clouds {clouds.shape} or non-finite")
        require(launches == {"edge_head": 4, "slot_stats": 3,
                             "bilateral_tail_gated": 3,
                             "bilateral_tail_plain": 1},
                f"num_k {num_k}: launches {launches}")
        stages = stage_check(model, dev)
        t0 = time.perf_counter()
        generate(2 * WIDE_B, WIDE_B, SEED, device=dev, model=model)
        torch.cuda.synchronize()
        cps = 2 * WIDE_B / (time.perf_counter() - t0)
        log(f"  time generate() at num_k {num_k}, B={WIDE_B}: {cps:.1f} "
            f"clouds/s")
        out["generate"][num_k] = {"launches": launches, "stages": stages,
                                  "clouds_per_s": cps}
        del model
    return out


# ------------------------------------------------ the bf16 slice: phase 2b
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor cores (data sheet)
# bf16 outputs of a kernel against its plain version: the largest difference
# in bf16 ulps of the larger magnitude, counted at no less than 2^-8 of the
# plain output's largest (a value near 0 after cancellation has ulps far
# below the sums' rounding). Both sides sum exact products in other fp32
# orders and round once, so a value at a bf16 midpoint rounds either way:
# 1 ulp; the gate rounds two factors and their product, 2
BF16_ULPS = 2.0


def bf16_ulps(a, b) -> float:
    """max |a - b| in bf16 ulps (2^(e - 7) at binary exponent e) of
    max(|a|, |b|, max|b| / 256), elementwise."""
    import torch

    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(
        float(b.abs().max()) * 2.0 ** -8).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def head_bf16(args):
    """The bf16 instance's operands from fp32 head inputs: features,
    weights, pcat and ppoint rounded to bf16, pb_* fp32."""
    import torch

    bf = torch.bfloat16
    (x, x_knn, wn, ca, pbp, am, wen, pbm, pcat, ppoint, k, window) = args
    c = (lambda t: None if t is None else t.to(bf).contiguous())
    return (c(x), c(x_knn), c(wn), c(ca), pbp, c(am), c(wen), pbm, c(pcat),
            c(ppoint), k, window)


def tail_bf16(args):
    """The bf16 instance's operands from fp32 tail inputs: inte, h, w2k and
    wi rounded to bf16, the rest fp32."""
    import torch

    bf = torch.bfloat16
    (partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias, k, sm) = args
    c = (lambda t: None if t is None else t.to(bf).contiguous())
    return (partial, c(inte), c(h), isc, ish, c(w2k), w2b, s2, t2, c(wi),
            bias, k, sm)


HEAD_WEIGHTS, TAIL_WEIGHTS = (2, 3, 5, 6), (5, 9)


def fp32_weights(args, at):
    """bf16 operands with the weights at ``at`` back in fp32 (exact), as the
    differentiable ``edge_head`` and ``tail`` take them: they round them to
    the same bf16 values inside, for the kernels."""
    return tuple(t.float() if i in at and t is not None else t
                 for i, t in enumerate(args))


def graph_near_ties(idx_k, idx_p, x, label: str):
    """Two graphs of the same input ``x`` equal but at near-ties: at most
    0.1% of entries differ, each within 1e-5 relative of the one it
    replaces in float64. Returns (fraction, largest gap)."""
    from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

    mism = idx_k != idx_p
    frac = float(mism.float().mean())
    gap = 0.0
    if bool(mism.any()):
        d = self_pairwise_sqdist(x.double())
        dk = d.gather(-1, idx_k.long())
        dp = d.gather(-1, idx_p.long())
        scale = dk.abs().maximum(dp.abs()).clamp_min(1e-12)
        gap = float(((dk - dp).abs() / scale)[mism].max())
        del d, dk, dp, scale
    require(frac <= 1e-3, f"{label}: {frac} of the graph differs")
    require(gap <= 1e-5, f"{label}: the graph differs beyond near-ties")
    return frac, gap


def compare_head_bf16(args, label: str) -> float:
    """The head's bf16 instance against its bf16 plain version: two
    launches bit-identical; the graph equal to ``knn_topk``'s on the fp32
    upcast of x_knn and to the plain one's but at near-ties; given the
    kernel's graph inte, wfea, wxyz within ``BF16_ULPS``, partial and the
    sums rel <= 1e-4. Returns the largest absolute error."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                      head_reference_given_idx)
    from pdgn_tpu_torch.ops.kernels.knn import knn_topk
    from pdgn_tpu_torch.ops.knn import knn_exclude_first
    from pdgn_tpu_torch.ops.pairwise import self_pairwise_sqdist

    (x, x_knn, wn_flat, conv_a, pb_point, a_merge, wen, pb_merge, pcat,
     ppoint, k, window) = args
    names = ("inte", "partial", "stats", "wfea", "wxyz", "wstats")
    got = edge_head(*fp32_weights(args, HEAD_WEIGHTS))
    again = edge_head(*fp32_weights(args, HEAD_WEIGHTS))
    torch.cuda.synchronize()
    for name, a, b in zip(("idx",) + names, got, again):
        require(a is None or torch.equal(a, b),
                f"head bf16 {label}: {name} differs between two launches")
    del again
    xk = x_knn.float()
    require(torch.equal(got[0], knn_topk(xk, xk, k + 1)[..., 1:]),
            f"head bf16 {label}: the graph is not knn_topk's of the upcast")
    idx_p = knn_exclude_first(self_pairwise_sqdist(xk), k)
    frac, gap = graph_near_ties(got[0], idx_p, xk, f"head bf16 {label}")
    log(f"  head bf16 {label}: idx mismatch {frac:.6f}, max near-tie gap "
        f"{gap:.3e}")
    want = head_reference_given_idx(x, wn_flat, conv_a, pb_point, a_merge,
                                    wen, pb_merge, pcat, ppoint, got[0], k,
                                    window)
    err = 0.0
    for name, g, w in zip(names, got[1:], want):
        if w is None:
            require(g is None, f"head bf16: {name} should be None")
            continue
        require(g.dtype == w.dtype, f"head bf16 {label}: {name} dtype "
                f"{g.dtype} != {w.dtype}")
        if g.dtype == torch.bfloat16:
            e = bf16_ulps(g, w)
            log(f"    {name}: {e:.2f} ulps")
            require(e <= BF16_ULPS, f"head bf16 {label}: {name} {e} ulps")
        else:
            e = rel(g, w)
            log(f"    {name}: rel {e:.3e}")
            require(e <= 1e-4, f"head bf16 {label}: {name} rel {e}")
        err = max(err, max_abs(g, w))
    return err


def compare_slot_stats_bf16(h, label: str, k: int = K) -> float:
    """Slot stats' bf16 instance against its plain version (fp32 products
    of the upcast): rel <= 1e-5; two launches bit-identical."""
    import torch
    from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                       stats_plain)

    s_k, S_k = slot_moment_stats(h, k)
    s_2, S_2 = slot_moment_stats(h, k)
    require(torch.equal(s_k, s_2) and torch.equal(S_k, S_2),
            f"slot_stats bf16 {label}: two launches differ")
    s_p, S_p = stats_plain(h, k)
    e1, e2 = rel(s_k, s_p), rel(S_k, S_p)
    log(f"  slot_stats bf16 {label}: s rel {e1:.3e}, S rel {e2:.3e}")
    require(e1 <= 1e-5 and e2 <= 1e-5, f"slot_stats bf16 {label} disagrees")
    return max(max_abs(s_k, s_p), max_abs(S_k, S_p))


def bf16_differing(a, b) -> float:
    """The share of entries in which two bf16 tensors differ."""
    return float((a != b).float().mean())


def compare_tail_bf16(args, label: str) -> float:
    """A tail's bf16 instance against its bf16 plain version, in two parts
    and as a whole. The gate g the kernel writes against the plain gate
    (``gate_reference``): within ``BF16_ULPS``, at most 0.1% of its entries
    differing (a factor at a bf16 midpoint). y against the bf16 rounding of
    the float64 merge of the kernel's own g: within 1 ulp, at most 0.1%
    differing (the merge's fp32 accumulation on the tensor cores). y against
    the plain version's y: at most 1% differing; its ulps printed (one g
    entry that rounds the other way moves a y near 0 by several ulps of
    1/256 of the largest)."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (gate_reference,
                                                           tail_kernel,
                                                           tail_reference)

    (partial, inte, h, isc, ish, w2k, w2b, s2, t2, wi, bias, k, sm) = args
    B, N, two_f = partial.shape
    y_k, g_k = tail_kernel(*args, keep_g=True)
    y_p = tail_reference(*args)
    require(y_k.dtype == y_p.dtype == g_k.dtype == torch.bfloat16,
            f"tail bf16 {label}: dtypes {y_k.dtype}, {y_p.dtype}")
    g_p = gate_reference(inte, h, isc, ish, w2k, w2b, s2, t2, k,
                         sm).reshape(B * N, -1)
    y64 = (partial.double().reshape(B * N, two_f) + g_k.double()
           @ wi.double() + bias.double()).to(torch.bfloat16)
    y64 = y64.reshape(B, N, two_f)
    e_g, f_g = bf16_ulps(g_k, g_p), bf16_differing(g_k, g_p)
    e_m, f_m = bf16_ulps(y_k, y64), bf16_differing(y_k, y64)
    e_y, f_y = bf16_ulps(y_k, y_p), bf16_differing(y_k, y_p)
    log(f"  tail bf16 {label}: g {e_g:.2f} ulps, {f_g:.6f} differing; y "
        f"against its float64 merge {e_m:.2f} ulps, {f_m:.6f}; against "
        f"the plain version {e_y:.2f} ulps, {f_y:.6f} (rel "
        f"{rel(y_k, y_p):.3e})")
    require(e_g <= BF16_ULPS and f_g <= 1e-3, f"tail bf16 {label}: g")
    require(e_m <= 1.0 and f_m <= 1e-3, f"tail bf16 {label}: the merge")
    require(f_y <= 1e-2, f"tail bf16 {label}: {f_y} of y differs")
    return max_abs(y_k, y_p)


def check_bf16_kernels(gen, dev) -> dict:
    """Phase 2b: the four bf16 instances against their bf16 plain versions
    at stage 4 (B=8; the plain head and tail at stage 1), at the widened k
    of phase 2w (14, 18) and at 4Fin = 130, 2F = 66 (the plain head's
    scalar columns; the tails' 2Fin = 65, staged by plain loads in bf16).
    Phase 4b holds them again at B=128."""
    import torch

    bf = torch.bfloat16
    errs = {
        "edge_head_bf16": max(
            compare_head_bf16(head_bf16(head_inputs(4, 8, True, gen, dev)),
                              "stage 4 B=8"),
            compare_head_bf16(head_bf16(head_inputs(1, 8, False, gen, dev)),
                              "stage 1 B=8")),
        "slot_stats_bf16": compare_slot_stats_bf16(
            torch.randn(8, stage_dims(4)[0], K * 64, generator=gen,
                        device=dev).to(bf), "stage 4 B=8"),
        "bilateral_tail_gated_bf16": compare_tail_bf16(
            tail_bf16(tail_inputs(4, 8, True, gen, dev)), "stage 4 B=8 gated"),
        "bilateral_tail_plain_bf16": compare_tail_bf16(
            tail_bf16(tail_inputs(1, 8, False, gen, dev)),
            "stage 1 B=8 plain"),
    }
    for k in WIDE_K:
        errs["edge_head_bf16"] = max(errs["edge_head_bf16"], compare_head_bf16(
            head_bf16(head_inputs(4, 8, True, gen, dev, k)),
            f"stage 4 B=8 k={k}"))
        errs["slot_stats_bf16"] = max(
            errs["slot_stats_bf16"], compare_slot_stats_bf16(
                torch.randn(8, stage_dims(4)[0], k * 64, generator=gen,
                            device=dev).to(bf), f"stage 4 B=8 k={k}", k))
        errs["bilateral_tail_gated_bf16"] = max(
            errs["bilateral_tail_gated_bf16"], compare_tail_bf16(
                tail_bf16(tail_inputs(4, 8, True, gen, dev, k)),
                f"stage 4 B=8 gated k={k}"))
    errs["edge_head_bf16"] = max(errs["edge_head_bf16"], compare_head_bf16(
        head_bf16(odd_head_inputs(8, gen, dev)),
        "stage 1 B=8 4Fin=130 2F=66"))
    for gated in (True, False):
        name = f"bilateral_tail_{'gated' if gated else 'plain'}_bf16"
        errs[name] = max(errs[name], compare_tail_bf16(
            tail_bf16(odd_tail_inputs(8, gated, gen, dev)),
            f"B=8 4Fin=130 2F=66 {'gated' if gated else 'plain'}"))
    return errs


# ------------------------------------------------ the bf16 slice: phase 3b
BF16_PER_FORWARD = {"edge_head_bf16": 4, "slot_stats_bf16": 3,
                    "bilateral_tail_gated_bf16": 3,
                    "bilateral_tail_plain_bf16": 1}


def matched_chamfer(a, b, chunk: int = 16):
    """Per-pair Chamfer distance (mean squared nearest distances, both
    ways) of clouds a[i] and b[i], (n, P, 3) on the card."""
    import torch

    out = []
    for i in range(0, a.shape[0], chunk):
        d = torch.cdist(a[i:i + chunk].double(), b[i:i + chunk].double()) ** 2
        out.append(d.min(2).values.mean(1) + d.min(1).values.mean(1))
    return torch.cat(out)


def main_path_bf16(dev, model32) -> dict:
    """Phase 3b: ``generate()`` (``--phase sample --compute_dtype
    bfloat16``) at full width, 256 clouds in batches of 128, on phase 3's
    weights, every counter set to 0 just before and read just after: the
    bf16 instances only, the clouds finite fp32. Against the fp32 path from
    the same noise as matched Chamfer distance, beside the Chamfer distance
    between two fp32 samples from different noise (the sampling gap): at
    random weights the bf16 policy moves the clouds by a large share of
    that gap in the JAX package too (0.69 of it on the CPU at base 16,
    tests/test_torch_bf16_generator.py), so the share is reported and held
    under 1. clouds/s for the record."""
    import numpy as np
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train.generate import build_generator, generate

    model = build_generator(SEED, dev, dtype=torch.bfloat16)
    model.load_state_dict(model32.state_dict())
    torch.cuda.synchronize()
    _lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    clouds = generate(256, 128, SEED, device=dev, model=model)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    log(f"  generate(256, B=128) in bf16: {clouds.shape} {clouds.dtype} in "
        f"{first_s:.3f} s, launches {launches}")
    want = {k: 2 * v for k, v in BF16_PER_FORWARD.items()}
    require(launches == want, f"bf16 launches {launches} != {want}")
    require(clouds.shape == (256, 2048, 3) and clouds.dtype == np.float32
            and bool(np.isfinite(clouds).all()),
            f"bf16 clouds {clouds.shape} {clouds.dtype} or non-finite")
    # each stage on the card against the plain CPU bf16 path's, rel <=
    # 2e-2 where the graphs agree (measured 3.9e-3 to 8.7e-3); the share of
    # ec's entries that differ is printed (0.25% to 7.5%: the batch norms'
    # E[x^2] - E[x]^2 variances, summed in other orders on the two
    # devices, move every normalised value by up to ~1e-4 relative where
    # the mean is large, so those at a bf16 midpoint round the other way)
    stages = stage_check(model, dev, tol=2e-2)
    c32 = generate(256, 128, SEED, device=dev, model=model32)
    other = generate(256, 128, SEED + 1, device=dev, model=model32)
    g = torch.from_numpy(clouds).to(dev)
    f = torch.from_numpy(c32).to(dev)
    o = torch.from_numpy(other).to(dev)
    gap_bf16 = float(matched_chamfer(g, f).mean())
    gap_sampling = float(matched_chamfer(o, f).mean())
    share = gap_bf16 / gap_sampling
    log(f"  matched Chamfer, bf16 vs fp32 from the same noise: {gap_bf16:.6e};"
        f" fp32 vs fp32 from other noise: {gap_sampling:.6e}; share "
        f"{share:.4f}")
    require(share < 1.0, f"bf16 clouds {share} of the sampling gap")
    del g, f, o
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(256, 128, SEED, device=dev, model=model)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    cps = [256 / s for s in times]
    log(f"  bf16 clouds/s at B=128 (256 clouds per run, for the record): "
        f"{cps}")
    return {"launches": launches, "clouds_per_s": cps, "first_run_s": first_s,
            "stages": stages, "chamfer_bf16_vs_fp32": gap_bf16,
            "chamfer_sampling": gap_sampling, "chamfer_share": share}


def test_path_bf16(root: str, dev) -> dict:
    """Phase 3be: ``PDGNTrainer.test`` with ``compute_dtype="bfloat16"``
    (``--phase test --compute_dtype bfloat16``) on 64 synthetic clouds at
    full width, seeded weights, counters set to 0 just before and read just
    after: the bf16 instances and ``emd_cd``; 13 finite metrics."""
    import numpy as np
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    save_dir = os.path.join(root, "pdgn_tpu_torch", "_build",
                            "smoke_test_bf16")
    shutil.rmtree(save_dir, ignore_errors=True)
    try:
        cfg = ExperimentConfig(batch_size=TRAIN_B, synthetic_size=TEST_CLOUDS,
                               checkpoint_dir=os.path.join(save_dir, "ckpt"),
                               model_dir="smoke", save_dir=save_dir,
                               device=dev.type, compute_dtype="bfloat16")
        trainer = PDGNTrainer(cfg)
        trainer.build_model(seed=SEED + 3)
        _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = trainer.test(tile=TEST_TILE)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    forwards = -(-TEST_CLOUDS // TRAIN_B)
    per_side = -(-TEST_CLOUDS // TEST_TILE)
    want = {k: v * forwards for k, v in BF16_PER_FORWARD.items()}
    want["emd_cd"] = 3 * per_side * per_side
    log(f"  test(tile={TEST_TILE}) in bf16 on {TEST_CLOUDS} clouds: "
        f"{test_s:.3f} s, launches {launches}")
    require(launches == want, f"bf16 test launches {launches} != {want}")
    for k, v in res.items():
        log(f"    {k}: {v:.12f}")
    require(len(res) == 13 and all(np.isfinite(v) for v in res.values()),
            f"bf16 test metrics {res}")
    return {"seconds": test_s, "launches": launches, "metrics": res}


# ------------------------------------------------ the bf16 slice: phase 4b
def time_bf16_kernels(dev, gen) -> dict:
    """Phase 4b: each bf16 instance at the main path's B=128 shapes (stage
    4; the plain tail stage 1), its bf16 plain version, the library call
    where one PyTorch call computes the same function, and the bound:
    products at the bf16 tensor-core rate (989 TFLOP/s dense), the rest at
    the fp32 SIMT rate, against bf16 bytes (fp32 for partial, pb_*, the
    sums and the folds); holds each against its plain version again."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import tail, tail_reference
    from pdgn_tpu_torch.ops.kernels.edge_head import edge_head, head_plain
    from pdgn_tpu_torch.ops.kernels.slot_stats import (slot_moment_stats,
                                                       stats_plain)

    bf = torch.bfloat16
    B = 128
    hk = K // 2
    window = hk + 1
    res = {}

    n, c, cx, four_fin, two_f = stage_dims(4)
    args = head_bf16(head_inputs(4, B, True, gen, dev))
    rows = B * n
    products = 2.0 * rows * c * ((window + 1) * four_fin + (K + 1) * two_f)
    simt = (2.0 * B * n * n * (c + cx)                   # kNN distances
            + 1.0 * rows * hk * window * four_fin        # window sums
            + 1.0 * rows * K * two_f                     # merge sums
            + 1.0 * rows * K * 32)                       # weight-net rows
    t_ops = (products / PEAK_BF16 + simt / PEAK_FLOPS) * 1e3
    nbytes = (2.0 * (rows * (c + cx) + rows * 64         # x, x_knn, pcat+pp
                     + (window + 1) * c * four_fin + (K + 1) * c * two_f
                     + rows * hk * four_fin + rows * K * 32)  # inte, wrows
              + 4.0 * (B * (four_fin + two_f) + rows * K + rows * two_f
                       + 2 * four_fin + 2 * K * 32))     # pb, idx, partial
    b, by = bound(0.0, nbytes, t_ops)
    wargs = fp32_weights(args, HEAD_WEIGHTS)
    res["edge_head_bf16"] = {
        "ms": time_ms(lambda: edge_head(*wargs), 3),
        "plain_ms": time_ms(lambda: head_plain(*args), 2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, C={c}+{cx}, 4Fin={four_fin}, "
                 f"2F={two_f}, gated, bf16"}
    res["edge_head_bf16"]["max_abs_err"] = compare_head_bf16(
        args, f"stage 4 B={B}")
    del args, wargs

    h = torch.randn(B, n, K * 64, generator=gen, device=dev).to(bf)
    srows = B * n * K
    b, by = bound(srows * 64.0, 2.0 * srows * 64 + 4.0 * (64 * 64 + 64),
                  srows * 64 * 65 / PEAK_BF16 * 1e3)
    hf = h.reshape(-1, 64)
    res["slot_stats_bf16"] = {
        "ms": time_ms(lambda: slot_moment_stats(h, K), 10),
        "plain_ms": time_ms(lambda: stats_plain(h, K), 10),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.matmul(hf.T, hf), 10),
        "shape": f"stage 4, B={B}, rows={srows}, H=64, bf16 (library: "
                 f"h.T @ h in bf16)"}
    res["slot_stats_bf16"]["max_abs_err"] = compare_slot_stats_bf16(
        h, f"stage 4 B={B}")
    del h, hf

    targs = tail_bf16(tail_inputs(4, B, True, gen, dev))
    two_fin = four_fin // 2
    products = (2.0 * rows * K * 64 * two_fin + 2.0 * rows * hk * four_fin
                * two_f)
    simt = 8.0 * rows * K * two_fin + 2.0 * rows * two_f
    nbytes = (2.0 * (rows * hk * four_fin + rows * K * 64 + rows * two_f
                     + hk * four_fin * two_f + 64 * two_fin)
              + 4.0 * (rows * two_f + 2 * four_fin + 4 * two_fin))
    b, by = bound(simt, nbytes, products / PEAK_BF16 * 1e3)
    wargs = fp32_weights(targs, TAIL_WEIGHTS)
    res["bilateral_tail_gated_bf16"] = {
        "ms": time_ms(lambda: tail(*wargs), 3),
        "plain_ms": time_ms(lambda: tail_reference(*targs), 3),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, 4Fin={four_fin}, 2F={two_f}, bf16"}
    res["bilateral_tail_gated_bf16"]["max_abs_err"] = compare_tail_bf16(
        targs, f"stage 4 B={B} gated")
    partial, wi = targs[0].reshape(rows, two_f), targs[9]
    del targs, wargs
    # the merge product alone against torch.addmm on bf16 operands (fp32
    # accumulation, bf16 out): a yardstick, never called by the port
    g = torch.randn(rows, hk * four_fin, generator=gen, device=dev).to(bf)
    pb = partial.to(bf)
    sub_ms = time_ms(lambda: torch.addmm(pb, g, wi), 3)
    flop = 2.0 * rows * hk * four_fin * two_f
    log(f"  sub-yardstick merge g @ wi + partial in bf16: torch.addmm "
        f"{sub_ms:.3f} ms ({flop / sub_ms / 1e9:.1f} TFLOP/s)")
    res["bilateral_tail_gated_bf16"]["sub_yardstick"] = {
        "what": "torch.addmm bf16 of the merge", "addmm_ms": sub_ms}
    del g, pb, partial, wi

    n1, _, _, four_fin1, two_f1 = stage_dims(1)
    targs = tail_bf16(tail_inputs(1, B, False, gen, dev))
    rows1 = B * n1
    products = 2.0 * rows1 * hk * four_fin1 * two_f1
    nbytes = (2.0 * (rows1 * hk * four_fin1 + rows1 * two_f1
                     + hk * four_fin1 * two_f1)
              + 4.0 * (rows1 * two_f1 + 2 * four_fin1))
    b, by = bound(3.0 * rows1 * hk * four_fin1 + 2.0 * rows1 * two_f1, nbytes,
                  products / PEAK_BF16 * 1e3)
    wargs = fp32_weights(targs, TAIL_WEIGHTS)
    res["bilateral_tail_plain_bf16"] = {
        "ms": time_ms(lambda: tail(*wargs), 10),
        "plain_ms": time_ms(lambda: tail_reference(*targs), 10),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 1, B={B}, N={n1}, 4Fin={four_fin1}, 2F={two_f1}, "
                 f"bf16"}
    res["bilateral_tail_plain_bf16"]["max_abs_err"] = compare_tail_bf16(
        targs, f"stage 1 B={B} plain")
    return res


# ------------------------------------------ the bf16 train slice: phase 2bt
def head_bwd_case_bf16(stage: int, B: int, gated: bool, gen, dev,
                       k: int = K):
    """The bf16 head's operands, its graph and forward from the bf16
    instance, and random cotangents as bf16 training gives them: bf16 for
    inte and the weight-net rows, fp32 holding bf16 values for partial (the
    bf16 tail's upcast cotangent), fp32 for the sums."""
    import torch
    from pdgn_tpu_torch.ops.kernels.edge_head import edge_head

    bf = torch.bfloat16
    args = head_bf16(head_inputs(stage, B, gated, gen, dev, k))
    idx, inte = edge_head(*fp32_weights(args, HEAD_WEIGHTS))[:2]
    n, _, _, four_fin, two_f = stage_dims(stage)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cts = [r(*inte.shape).to(bf), r(B, n, two_f).to(bf).float(),
           r(2, four_fin, scale=0.01)]
    if gated:
        cts += [r(B, n, k * 16).to(bf), r(B, n, k * 16).to(bf),
                r(2, k * 32, scale=0.01)]
    return args, idx, inte, cts


def compare_bf16_grads(names, got, want, label: str, rows_ok=None) -> float:
    """Each gradient of a bf16 backward instance against its plain version:
    dtypes equal, bf16 ones within ``BF16_ULPS``, fp32 ones rel <= 1e-4;
    ``rows_ok`` maps a name to the mask of the rows to hold (the rest at a
    kink, counted apart). Returns the largest absolute error."""
    import torch

    err, worst = 0.0, {}
    for name, g, w in zip(names, got, want):
        if w is None:
            require(g is None, f"{label}: {name} should be None")
            continue
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{label}: d{name} {g.dtype} {tuple(g.shape)} against "
                f"{w.dtype} {tuple(w.shape)}")
        if rows_ok is not None and name in rows_ok:
            keep = rows_ok[name]
            g, w = g.reshape(keep.numel(), -1)[keep], w.reshape(
                keep.numel(), -1)[keep]
        if g.dtype == torch.bfloat16:
            e = bf16_ulps(g, w)
            require(e <= BF16_ULPS, f"{label}: d{name} {e} bf16 ulps")
            worst[name] = f"{e:.3g} ulps"
        else:
            e = rel(g, w)
            require(e <= 1e-4, f"{label}: d{name} rel {e}")
            worst[name] = f"rel {e:.2e}"
        err = max(err, max_abs(g, w))
    log(f"  {label}: {worst}")
    return err


def compare_head_bwd_bf16(case, label: str) -> float:
    """The bf16 head backward against ``head_bwd_plain_bf16`` on the same
    graph, forward and cotangents; a second launch bit-identical."""
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain_bf16)

    args, idx, inte, cts = case
    x, _, wn, ca, _, am, wen, _, pcat, ppoint, k, window = args
    before = _lib.LAUNCHES["edge_head_bwd_bf16"]
    got = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                          k)
    again = head_bwd_kernel(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts,
                            k)
    require(_lib.LAUNCHES["edge_head_bwd_bf16"] == before + 2,
            "head bwd bf16: launches not counted")
    require(all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
            f"head bwd bf16 {label}: two launches differ")
    want = head_bwd_plain_bf16(x, idx, inte, wn, ca, am, wen, pcat, ppoint,
                               cts, k, window)
    return compare_bf16_grads(HEAD_GRADS, got, want, f"head bwd bf16 {label}")


def compare_tail_bwd_bf16(args, dy, label: str):
    """The bf16 tail backward against ``tail_bwd_plain_bf16``; a second
    launch bit-identical. Each rounded operand is held to the plain
    version's (d_inte, the d_wi operand g, the d_h and d_w2k operand dv:
    ``BF16_ULPS``), each product to the float64 product of the kernel's own
    operands (d_h rounded to bf16 within 1 ulp; d_wi, d_w2k rel <= 1e-4),
    the sums to the plain version's (rel <= 1e-4): a value within fp32
    rounding of a bf16 midpoint may round the other way on either side,
    and a sum of such operands with cancellation moves by many of its own
    ulps. The gated tail's slot-logit entries at a kink (``kink_mask``:
    each side takes LeakyReLU's branch from its own fp32 sum) are counted;
    dv is held on the (point, slot) rows free of them, and the sums over
    the slot logits (d_w2b, d_t2, d_s2) to the plain version's within rel
    1e-4 plus what the two sides' dv at the kink entries account for.
    Returns (largest absolute error, share of entries at a kink)."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (
        kink_mask, tail_bwd_kernel_bf16, tail_bwd_plain_bf16)

    bf = torch.bfloat16
    k, softmax = args[11], args[12]
    gated = args[2] is not None
    keep = dict(keep_g=True, keep_dv=True)
    got = tail_bwd_kernel_bf16(*args[1:10], dy, k, softmax, **keep)
    again = tail_bwd_kernel_bf16(*args[1:10], dy, k, softmax, **keep)
    require(all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
            f"tail bwd bf16 {label}: two launches differ")
    del again
    want = tail_bwd_plain_bf16(*args[1:10], dy, k, softmax, **keep)
    res, err = {}, 0.0

    def ulps(name, a, b, limit=BF16_ULPS):
        nonlocal err
        require(a.dtype == b.dtype == bf and a.shape == b.shape,
                f"{label}: {name} {a.dtype} {tuple(a.shape)}")
        e = bf16_ulps(a, b)
        require(e <= limit, f"tail bwd bf16 {label}: {name} {e} bf16 ulps")
        res[name] = f"{e:.3g} ulps"
        err = max(err, max_abs(a, b))

    def close(name, a, b, allow=None):
        nonlocal err
        require(a.dtype == torch.float32 and a.shape == b.shape,
                f"{label}: {name} {a.dtype} {tuple(a.shape)}")
        e = rel(a, b)
        if allow is not None:   # the kinks' share taken out first
            over = ((a.double() - b.double()).abs() - allow).clamp_min(0)
            e = float(over.max() / b.double().abs().max().clamp_min(1e-12))
        require(e <= 1e-4, f"tail bwd bf16 {label}: {name} rel {e}")
        res[name] = f"rel {e:.2e}" + ("" if allow is None else
                                      f" (raw {rel(a, b):.2e})")
        err = max(err, max_abs(a, b))

    g_k = got[11]
    rows = g_k.shape[0]
    ulps("d_inte", got[1], want[1])
    ulps("g", g_k, want[11])
    close("d_wi", got[9], g_k.double().T @ dy.reshape(rows, -1).double())
    for i, name in ((3, "d_isc"), (4, "d_ish"), (10, "d_bias"),
                    (0, "d_partial")):
        close(name, got[i], want[i])
    share = 0.0
    if gated:
        dv_k, h = got[12], args[2].reshape(rows, k, -1)
        kinks = kink_mask(args[2], *args[5:9], k)
        share = float(kinks.float().mean())
        ok = ~kinks.any(-1)
        ulps("dv", dv_k[ok], want[12][ok])
        w2k = args[5].to(bf).double()
        ulps("d_h", got[2].reshape(rows, k, -1),
             (dv_k.double() @ w2k.T).to(bf), 1.0)
        close("d_w2k", got[5],
              torch.einsum("rsh,rsc->hc", h.double(), dv_k.double()))
        # at a kink entry the two dpre differ by what the two dv differ
        # (each rounded to bf16: 2^-8 of each added); dhat = dpre / s2
        s2 = args[7].double().abs()
        pre = h.double() @ w2k + args[6].double()
        dd = ((dv_k.double() - want[12].double()).abs()
              + (dv_k.double().abs() + want[12].double().abs()) * 2.0 ** -8)
        dd = dd * kinks
        allow = {"d_w2b": dd.sum((0, 1)), "d_t2": dd.sum((0, 1)) / s2,
                 "d_s2": (dd * pre.abs()).sum((0, 1)) / s2}
        for i, name in ((6, "d_w2b"), (7, "d_s2"), (8, "d_t2")):
            close(name, got[i], want[i], allow[name])
        log(f"  tail bwd bf16 {label}: {int(kinks.sum())} slot-logit "
            f"entries at a kink (share {share:.3e}); dv held on "
            f"{int(ok.sum())} of {ok.numel()} (point, slot) rows")
    log(f"  tail bwd bf16 {label}: {res}")
    return err, share


def check_bf16_train_kernels(gen, dev) -> dict:
    """Phase 2bt: the three bf16 backward instances against their bf16 plain
    versions at stage 4 and stage 1 (B=35) and at phase 2w's k (B=8);
    phase 4bt holds them again where it times them."""
    import torch

    bf = torch.bfloat16
    B = TRAIN_B
    errs = {"edge_head_bwd_bf16": 0.0, "bilateral_tail_gated_bwd_bf16": 0.0,
            "bilateral_tail_plain_bwd_bf16": 0.0}
    kinks = {}
    cases = [(4, B, True, K), (1, B, False, K)] + [(4, 8, True, k)
                                                    for k in WIDE_K]
    for stage, b, gated, k in cases:
        label = f"stage {stage} B={b} k={k}"
        errs["edge_head_bwd_bf16"] = max(
            errs["edge_head_bwd_bf16"], compare_head_bwd_bf16(
                head_bwd_case_bf16(stage, b, gated, gen, dev, k), label))
        targs = tail_bf16(tail_inputs(stage, b, gated, gen, dev, k))
        dy = torch.randn(*targs[0].shape, generator=gen, device=dev).to(bf)
        name = f"bilateral_tail_{'gated' if gated else 'plain'}_bwd_bf16"
        e, share = compare_tail_bwd_bf16(targs, dy, label)
        errs[name] = max(errs[name], e)
        if gated:
            kinks[label] = share
        del targs, dy
    return errs, kinks


# ------------------------------------------ the bf16 train slice: phase 3bt
BF16_PER_STEP = {"edge_head_bf16": 8, "edge_head_bwd_bf16": 4,
                 "slot_stats_bf16": 6, "bilateral_tail_gated_bf16": 6,
                 "bilateral_tail_gated_bwd_bf16": 3,
                 "bilateral_tail_plain_bf16": 2,
                 "bilateral_tail_plain_bwd_bf16": 1,
                 "local_stats_fwd": 9, "local_stats_bwd": 9}
BF16_D_STEPS = 3         # steps with bf16 discriminators too
BF16_CLI_STEPS = 3       # steps of the CLI's bf16 train run


def train_path_bf16(root: str, smi: str) -> dict:
    """Phase 3bt: ``PDGNTrainer.train`` with ``compute_dtype="bfloat16"`` at
    full width, B=35, synthetic (``--phase train --compute_dtype
    bfloat16``): TRAIN_STEPS steps, counters set to 0 just before and read
    just after (the bf16 instances only, forward and backward, and the
    fp32 local statistics of the shape loss); finite losses and gradients,
    fp32 parameters that moved; steps/s as a reading. Then BF16_D_STEPS
    steps with ``d_compute_dtype="bfloat16"`` too, finite, and the CLI's
    bf16 train (``cli.main``) for BF16_CLI_STEPS steps."""
    import math

    import numpy as np
    import torch
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    work = os.path.join(root, "pdgn_tpu_torch", "_build", "smoke_train_bf16")
    shutil.rmtree(work, ignore_errors=True)
    try:
        cfg = ExperimentConfig(batch_size=TRAIN_B, max_epoch=1,
                               max_steps_per_epoch=TRAIN_STEPS,
                               synthetic_size=TRAIN_B * TRAIN_STEPS,
                               checkpoint_dir=os.path.join(work, "ckpt"),
                               model_dir="smoke", device="cuda",
                               compute_dtype="bfloat16")
        trainer = PDGNTrainer(cfg)
        trainer.build_model(seed=SEED)
        st = trainer.state
        require(st.generator.dtype == torch.bfloat16
                and all(d.dtype is None for d in st.discriminators),
                "bf16 generator, fp32 discriminators expected")
        g_before = [p.detach().clone() for p in st.generator.parameters()]
        np.random.seed(SEED)
        _lib.LAUNCHES.clear()
        trainer.train(seed=SEED)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        steps = len(trainer.step_seconds)
        log(f"  {steps} bf16 train steps at B={TRAIN_B}, launches "
            f"{launches}")
        require(steps == TRAIN_STEPS, f"{steps} steps ran")
        want = {k: v * steps for k, v in BF16_PER_STEP.items()}
        require(launches == want, f"bf16 launches {launches} != {want}")
        m = trainer.last_metrics
        require(len(m) == 6 and all(math.isfinite(v) for v in m.values()),
                f"bf16 losses {m}")
        for net in (st.generator,) + st.discriminators:
            for name, p in net.named_parameters():
                require(p.dtype == torch.float32 and p.grad is not None
                        and bool(torch.isfinite(p.grad).all()),
                        f"{name}: no finite fp32 gradient")
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(g_before, st.generator.parameters()))
        require(moved > 0, "the bf16 generator's parameters did not move")
        timed = trainer.step_seconds[1:]
        sps = len(timed) / sum(timed)
        log(f"  bf16 train step seconds {trainer.step_seconds}; steps/s at "
            f"B={TRAIN_B} over the {len(timed)} timed steps: {sps:.4f} (a "
            f"reading); last losses {m}; generator tensors moved {moved}")
        del trainer, st, g_before

        dcfg = dataclasses.replace(
            cfg, max_steps_per_epoch=BF16_D_STEPS, model_dir="smoke_d",
            synthetic_size=TRAIN_B * BF16_D_STEPS,
            d_compute_dtype="bfloat16")
        dtrainer = PDGNTrainer(dcfg)
        dtrainer.build_model(seed=SEED + 5)
        require(all(d.dtype == torch.bfloat16
                    for d in dtrainer.state.discriminators),
                "bf16 discriminators expected")
        dtrainer.train(seed=SEED + 5)
        dm = dtrainer.last_metrics
        require(len(dtrainer.step_seconds) == BF16_D_STEPS
                and all(math.isfinite(v) for v in dm.values()),
                f"d_compute_dtype bfloat16: losses {dm}")
        log(f"  {BF16_D_STEPS} steps with bf16 discriminators too: last "
            f"losses {dm}")
        del dtrainer

        # the CLI's entry (what python -m pdgn_tpu_torch runs), in this
        # process as phase 3d drives it
        from pdgn_tpu_torch import cli

        argv = ["--network", "PDGNet_v2", "--phase", "train",
                "--compute_dtype", "bfloat16", "--dataset", "synthetic",
                "--batch_size", str(TRAIN_B), "--synthetic_size",
                str(TRAIN_B * BF16_CLI_STEPS), "--max_epoch", "1",
                "--model_dir", "smoke_cli", "--checkpoint_dir",
                os.path.join(work, "cli_ckpt"), "--save_dir",
                os.path.join(work, "cli_out")]
        t0 = time.perf_counter()
        ctr = cli.main(argv)
        cli_s = time.perf_counter() - t0
        cm = ctr.last_metrics
        require(ctr.state.generator.dtype == torch.bfloat16
                and len(ctr.step_seconds) == BF16_CLI_STEPS
                and all(math.isfinite(v) for v in cm.values()),
                f"the CLI's bf16 train: {len(ctr.step_seconds)} steps, "
                f"losses {cm}")
        log(f"  cli.main(--phase train --compute_dtype bfloat16 --dataset "
            f"synthetic): {BF16_CLI_STEPS} steps, {cli_s:.1f} s; last "
            f"losses {cm}")
        del ctr
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "steps_per_s": sps,
            "step_seconds": timed, "metrics": m, "d_bf16_metrics": dm,
            "cli_seconds": cli_s,
            "per_step": {k: v // steps for k, v in launches.items()},
            "card": smi}


# ------------------------------------------ the bf16 train slice: phase 4bt
def time_bf16_train_kernels(dev, gen) -> dict:
    """Phase 4bt: each bf16 backward instance at the train path's B=35
    shapes (stage 4; the plain tail stage 1), its bf16 plain version and
    its bound: the products at the bf16 tensor-core rate (989 TFLOP/s
    dense; the head's least work the gathered design's 7 + 7 and 11 + 11
    products a point, as its fp32 row counts it), the rest as phase 4t
    counts it at the fp32 SIMT rate, against bf16 bytes where the data is
    bf16; holds each against its plain version again."""
    import torch
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import (
        tail_bwd_kernel, tail_bwd_plain_bf16)
    from pdgn_tpu_torch.ops.kernels.edge_head import (head_bwd_kernel,
                                                      head_bwd_plain_bf16)

    bf = torch.bfloat16
    B = TRAIN_B
    hk = K // 2
    window = hk + 1
    res = {}

    n, c, cx, four_fin, two_f = stage_dims(4)
    case = head_bwd_case_bf16(4, B, True, gen, dev)
    args, idx, inte, cts = case
    x, _, wn, ca, _, am, wen, _, pcat, ppoint, k, _ = args
    rows = B * n
    products = (2 * 2.0 * rows * (window + 1) * c * four_fin
                + 2 * 2.0 * rows * (K + 1) * c * two_f)
    simt = (3.0 * rows * hk * four_fin                   # dy
            + 1.0 * rows * hk * (window + 1) * four_fin  # A_t and S sums
            + 1.0 * rows * K * c                         # merge gather
            + 1.0 * rows * c)                            # d_x addend
    nbytes = (2.0 * (rows * c + 2 * rows * hk * four_fin  # x, inte, d_inte
                     + (window + 1) * c * four_fin + (K + 1) * c * two_f
                     + 2 * rows * K * 16 + 2 * rows * 32  # d_w*, pcat, pp
                     + rows * c + 2 * rows * 32)          # d_x, d_pc, d_pp
              + 4.0 * (rows * K + rows * two_f + 2 * four_fin + 2 * K * 32
                       + (window + 1) * c * four_fin + (K + 1) * c * two_f
                       + B * (four_fin + two_f)))
    b, by = bound(simt, nbytes, products / PEAK_BF16 * 1e3)
    res["edge_head_bwd_bf16"] = {
        "ms": time_ms(lambda: head_bwd_kernel(x, idx, inte, wn, ca, am, wen,
                                              pcat, ppoint, cts, k), 3),
        "plain_ms": time_ms(lambda: head_bwd_plain_bf16(
            x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts, k, window), 2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, C={c}+{cx}, gated, bf16"}
    res["edge_head_bwd_bf16"]["max_abs_err"] = compare_head_bwd_bf16(
        case, f"stage 4 B={B}")
    del case, args, idx, inte, cts, x

    two_fin = four_fin // 2
    KK = hk * four_fin
    targs = tail_bf16(tail_inputs(4, B, True, gen, dev))
    dy = torch.randn(*targs[0].shape, generator=gen, device=dev).to(bf)
    products = (2 * 2.0 * rows * KK * two_f          # dg and d_wi
                + 3 * 2.0 * rows * K * 64 * two_fin)  # conv_all2, d_h, d_w2k
    simt = 30.0 * rows * K * two_fin                 # gate, softmax, BN walk
    nbytes = (2.0 * (2 * rows * KK + 2 * rows * K * 64 + rows * two_f
                     + KK * two_f + 64 * two_fin)
              + 4.0 * (rows * two_f + KK * two_f + 64 * two_fin
                       + 4 * four_fin + 6 * two_fin))
    b, by = bound(simt, nbytes, products / PEAK_BF16 * 1e3)
    res["bilateral_tail_gated_bwd_bf16"] = {
        "ms": time_ms(lambda: tail_bwd_kernel(*targs[1:10], dy, K, True), 3),
        "plain_ms": time_ms(lambda: tail_bwd_plain_bf16(
            *targs[1:10], dy, K, True), 2),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 4, B={B}, N={n}, 4Fin={four_fin}, 2F={two_f}, bf16"}
    e, share = compare_tail_bwd_bf16(targs, dy, f"stage 4 B={B} gated")
    res["bilateral_tail_gated_bwd_bf16"].update(max_abs_err=e,
                                                kink_share=share)
    del targs, dy

    n1, _, _, four_fin1, two_f1 = stage_dims(1)
    targs = tail_bf16(tail_inputs(1, B, False, gen, dev))
    dy = torch.randn(*targs[0].shape, generator=gen, device=dev).to(bf)
    rows1 = B * n1
    products = 2 * 2.0 * rows1 * hk * four_fin1 * two_f1
    nbytes = (2.0 * (2 * rows1 * hk * four_fin1 + rows1 * two_f1
                     + hk * four_fin1 * two_f1)
              + 4.0 * (rows1 * two_f1 + hk * four_fin1 * two_f1
                       + 4 * four_fin1))
    b, by = bound(6.0 * rows1 * hk * four_fin1, nbytes,
                  products / PEAK_BF16 * 1e3)
    res["bilateral_tail_plain_bwd_bf16"] = {
        "ms": time_ms(lambda: tail_bwd_kernel(*targs[1:10], dy, K, True), 10),
        "plain_ms": time_ms(lambda: tail_bwd_plain_bf16(
            *targs[1:10], dy, K, True), 10),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 1, B={B}, N={n1}, 4Fin={four_fin1}, 2F={two_f1}, "
                 f"bf16"}
    res["bilateral_tail_plain_bwd_bf16"]["max_abs_err"] = (
        compare_tail_bwd_bf16(targs, dy, f"stage 1 B={B} plain")[0])
    return res


# ----------------------------------------------- the train slice: phase 3t
TRAIN_B = 35
TRAIN_STEPS = 21         # one warm-up, twenty timed
PER_STEP = {"edge_head": 8, "edge_head_bwd": 4, "slot_stats": 6,
            "bilateral_tail_gated": 6, "bilateral_tail_gated_bwd": 3,
            "bilateral_tail_plain": 2, "bilateral_tail_plain_bwd": 1,
            "local_stats_fwd": 9, "local_stats_bwd": 9}


def train_path(ckpt_root: str) -> dict:
    """The train path through the trainer at full width, B=35; leaves its
    bundles under ``ckpt_root`` for the test path (phase 3e)."""
    import math

    import numpy as np
    import torch
    import pdgn_tpu_torch.train.trainer as trainer_mod
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train import checkpoint as ckpt_lib
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

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
    # each step's start, for the period from one step to the next: it holds
    # the batch's production, copy and wait whatever span the trainer times
    starts, step_fn = [], trainer_mod.train_step

    def timed_step(*args, **kwargs):
        starts.append(time.perf_counter())
        return step_fn(*args, **kwargs)

    np.random.seed(SEED)
    _lib.LAUNCHES.clear()
    trainer_mod.train_step = timed_step
    try:
        trainer.train(seed=SEED)
    finally:
        trainer_mod.train_step = step_fn
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
    timed = trainer.step_seconds[1:]
    sps = len(timed) / sum(timed)
    periods = np.diff(starts[1:])
    sps_period = len(periods) / float(periods.sum())
    log(f"  train step seconds {trainer.step_seconds}; steps/s at "
        f"B={TRAIN_B} over the {len(timed)} timed steps: {sps:.4f}; over "
        f"each step's start to the next (steps 2..{steps}): "
        f"{sps_period:.4f}; last losses {m}; generator tensors moved "
        f"{moved}")
    return {"launches": launches, "steps_per_s": sps,
            "steps_per_s_period": sps_period,
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

    B = TRAIN_B
    hk = K // 2
    window = hk + 1
    res = {}

    # head backward, gated, stage 4: its least work. The cotangents summed
    # onto their rows first (the transpose of x[idx] W = (x W)[idx]), so
    # window+1 products of C x 4Fin a point each way for the window conv
    # and k+1 of C x 2F each way for the merge, at 3xTF32's rate; forming
    # dy, the gathered sums and the merge's gather at the fp32 SIMT rate
    n, c, cx, four_fin, two_f = stage_dims(4)
    case = head_bwd_case(4, B, True, gen, dev)
    args, idx, inte, cts = case
    x, _, wn, ca, pb, am, wen, pbm, pcat, ppoint, k, _ = args
    rows = B * n
    products = (2 * 2.0 * rows * (window + 1) * c * four_fin
                + 2 * 2.0 * rows * (K + 1) * c * two_f)
    simt = (3.0 * rows * hk * four_fin                   # dy
            + 1.0 * rows * hk * (window + 1) * four_fin  # A_t and S sums
            + 1.0 * rows * K * c                         # merge gather
            + 1.0 * rows * c)                            # d_x addend
    nbytes = 4.0 * (rows * c + rows * K + 2 * rows * hk * four_fin
                    + rows * two_f + 2 * four_fin
                    + (window + 1) * c * four_fin + (K + 1) * c * two_f
                    + 2 * rows * K * 16 + 2 * K * 32 + 2 * rows * 32
                    + rows * c + (window + 1) * c * four_fin
                    + (K + 1) * c * two_f + B * (four_fin + two_f)
                    + 2 * rows * 32)
    b, by = bound(simt, nbytes, products / PEAK_TF32X3 * 1e3)
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
    # its input-gradient product alone, Gc (rows, 7*4Fin) @ W_conv + dxm,
    # against cuBLAS's fp32 SGEMM
    gc = torch.randn(rows, (window + 1) * four_fin, generator=gen,
                     device=dev)
    w_conv = torch.randn((window + 1) * four_fin, c, generator=gen,
                         device=dev) * 0.03
    dxm = torch.randn(rows, c, generator=gen, device=dev)
    res["edge_head_bwd"]["sub_yardstick"] = product_yardstick(
        "head bwd Gc @ W_conv + dxm", gc, w_conv, dxm)
    del gc, w_conv, dxm

    # gated tail backward, stage 4: dg and d_wi, conv_all2's recompute, d_h
    # and d_w2k on the tensor cores at 3xTF32's rate; the walk back through
    # the gate, the softmax and the BN folds at the fp32 SIMT rate
    targs = tail_inputs(4, B, True, gen, dev)
    dy = torch.randn(*targs[0].shape, generator=gen, device=dev)
    two_fin = four_fin // 2
    KK = hk * four_fin
    products = (2 * 2.0 * rows * KK * two_f          # dg and d_wi
                + 3 * 2.0 * rows * K * 64 * two_fin)  # conv_all2, d_h, d_w2k
    simt = 30.0 * rows * K * two_fin                 # gate, softmax, BN walk
    nbytes = 4.0 * (2 * rows * KK + 2 * rows * K * 64 + 2 * rows * two_f
                    + 2 * KK * two_f + 2 * 64 * two_fin + 4 * four_fin
                    + 6 * two_fin)
    b, by = bound(simt, nbytes, products / PEAK_TF32X3 * 1e3)
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
    products = 2 * 2.0 * rows1 * hk * four_fin1 * two_f1   # dg and d_wi
    nbytes = 4.0 * (2 * rows1 * hk * four_fin1 + 2 * rows1 * two_f1
                    + 2 * hk * four_fin1 * two_f1 + 4 * four_fin1)
    b, by = bound(6.0 * rows1 * hk * four_fin1, nbytes,
                  products / PEAK_TF32X3 * 1e3)
    res["bilateral_tail_plain_bwd"] = {
        "ms": time_ms(lambda: tail_bwd_kernel(*targs[1:10], dy, K, True), 10),
        "plain_ms": time_ms(lambda: tail_bwd_plain(*targs[:11], dy, K, True),
                            10),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"stage 1, B={B}, N={n1}, 4Fin={four_fin1}, 2F={two_f1}"}
    res["bilateral_tail_plain_bwd"]["max_abs_err"] = compare_tail_bwd(
        targs, dy, f"stage 1 B={B} plain")
    del targs, dy
    res.update(time_local_stats(B, gen, dev))
    return res


def time_local_stats(B: int, gen, dev) -> dict:
    """Phase 4t's local statistics at batch ``B``: the forward's and the
    backward's entries of the kernels line."""
    import torch
    from pdgn_tpu_torch.ops.kernels.local_stats import (bwd_kernel,
                                                        bwd_mask_plain,
                                                        bwd_plain,
                                                        fwd_kernel,
                                                        knn_direct,
                                                        stats_given_idx)

    res = {}
    # local stats, forward and backward: the 9 calls of one train step (the
    # shape loss's 3 self and 6 cross pairs), timed and bounded one by one
    # and summed; each selection equal to the plain one, mu and cov rel <=
    # 1e-4, the residual equal to the plain one and rebuilding every set,
    # d_src rel <= 1e-4 of bwd_plain. The forward's least work: the
    # distances (3 sub, 3 mul, 2 add) and one compare per (center, point);
    # the backward's: the same per (center, point), and 24 FLOP per
    # selected pair (k a center). The backward's launches take ~10 us, as
    # long as their host calls, so they are timed queued behind a sleeping
    # kernel (device time back to back); the largest call also as before.
    kk = 20
    clouds = shape_loss_clouds(B, gen, dev)
    ms = plain = err = 0.0
    bounds = []
    bwd = {"ms": 0.0, "plain_ms": 0.0, "gather_vjp_ms": 0.0, "err": 0.0,
           "bounds": [], "by_call": []}
    for M, N in SHAPE_LOSS_CALLS:
        src, centers = clouds[N], clouds[M]
        ms += time_ms(lambda: fwd_kernel(src, centers, kk), 10)
        plain += time_ms(lambda: stats_given_idx(
            src, knn_direct(src, centers, kk).long()), 2)
        bounds.append(bound(9.0 * B * M * N, 4.0 * (
            B * N * 3 + B * M * 3 + B * M * (3 + 9 + kk + 2))))
        idx_k, theta, tie, mu_k, cov_k = fwd_kernel(src, centers, kk)
        idx_p = knn_direct(src, centers, kk)
        mu_p, cov_p = stats_given_idx(src, idx_p.long())
        e_mu, e_cov = rel(mu_k, mu_p), rel(cov_k, cov_p)
        label = f"M={M} N={N} B={B}"
        require(torch.equal(idx_k, idx_p),
                f"local stats {label}: the selection differs")
        require(e_mu <= 1e-4 and e_cov <= 1e-4,
                f"local stats {label}: mu {e_mu}, cov {e_cov}")
        err = max(err, max_abs(mu_k, mu_p), max_abs(cov_k, cov_p))
        check_residual(src, centers, kk, idx_k, theta, tie, label)
        g_mu = torch.randn(B, M, 3, generator=gen, device=dev)
        g_cov = torch.randn(B, M, 9, generator=gen, device=dev)
        bargs = (src, centers, theta, tie, mu_k, g_mu, g_cov, kk)
        d_k = bwd_kernel(*bargs)
        d_p = bwd_plain(src, idx_k, g_mu, g_cov)
        e_b = rel(d_k, d_p)
        require(e_b <= 1e-4, f"local stats {label} bwd: {e_b}")
        bwd["err"] = max(bwd["err"], max_abs(d_k, d_p))
        row = {"M": M, "N": N, "ms": queued_ms(lambda: bwd_kernel(*bargs),
                                               20),
               "plain_ms": time_ms(lambda: bwd_mask_plain(*bargs), 2),
               "gather_vjp_ms": time_ms(lambda: bwd_plain(
                   src, idx_k, g_mu, g_cov), 2),
               "bound": bound(9.0 * B * M * N + 24.0 * B * M * kk, 4.0 * (
                   B * N * 3 + B * M * (3 + 2 + 3 + 3 + 9) + B * N * 3))}
        for key in ("ms", "plain_ms", "gather_vjp_ms"):
            bwd[key] += row[key]
        bwd["bounds"].append(row["bound"])
        bwd["by_call"].append(row)
        log(f"  local_stats {label}: indices equal, residual equal to the "
            f"plain one and rebuilding every set, mu rel {e_mu:.3e}, cov rel "
            f"{e_cov:.3e}, d_src rel {e_b:.3e}; bwd {row['ms']:.4f} ms "
            f"(queued), bound {row['bound'][0]:.4f} ms")
        del idx_k, theta, tie, mu_k, cov_k, idx_p, mu_p, cov_p, d_k, d_p
    res["local_stats_fwd"] = {
        "ms": ms, "plain_ms": plain, "bound_ms": sum(b for b, _ in bounds),
        "bound_by": max(bounds)[1],
        "library_ms": None, "max_abs_err": err,
        "shape": f"the 9 calls of a train step summed, B={B}, k={kk}, "
                 f"(M, N) in {SHAPE_LOSS_CALLS}"}
    del clouds

    # the backward's largest call of the step, 2048 points, 1024 centers,
    # also timed unqueued (the earlier measure) and checked as in 2t
    M, N = 1024, 2048
    case = local_case(B, M, N, gen, dev)
    src, centers, g_mu, g_cov = case
    _, theta, tie, mu_k, _ = fwd_kernel(src, centers, kk)
    largest = {
        "ms": time_ms(lambda: bwd_kernel(src, centers, theta, tie, mu_k,
                                         g_mu, g_cov, kk), 10),
        "queued_ms": queued_ms(lambda: bwd_kernel(
            src, centers, theta, tie, mu_k, g_mu, g_cov, kk), 20),
        "plain_ms": time_ms(lambda: bwd_mask_plain(
            src, centers, theta, tie, mu_k, g_mu, g_cov, kk), 5),
        "bound_ms": bound(9.0 * B * M * N + 24.0 * B * M * kk, 4.0 * (
            B * N * 3 + B * M * 20 + B * N * 3))[0],
        "shape": f"B={B}, M={M} centers, N={N} points, k={kk}"}
    err_b = max(bwd["err"], compare_local(case, f"M={M} N={N} B={B}")[1])
    res["local_stats_bwd"] = {
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "gather_vjp_ms": bwd["gather_vjp_ms"],
        "bound_ms": sum(b for b, _ in bwd["bounds"]),
        "bound_by": max(bwd["bounds"])[1], "library_ms": None,
        "max_abs_err": err_b, "largest_call": largest,
        "by_call": bwd["by_call"],
        "shape": f"the 9 calls of a train step summed (device time queued), "
                 f"B={B}, k={kk}, (M, N) in {SHAPE_LOSS_CALLS}"}
    log(f"  local_stats_bwd largest call ({largest['shape']}): "
        f"{largest['ms']:.4f} ms, queued {largest['queued_ms']:.4f} ms, "
        f"plain {largest['plain_ms']:.3f} ms, bound "
        f"{largest['bound_ms']:.4f} ms")
    return res


# ------------------------------------------------ the test slice: phase 2e
EMD_N = 2048             # points per cloud on the test path
TEST_CLOUDS = 64         # test-set size of phase 3e
TEST_TILE = 64           # clouds per side of one emd_cd launch
CHAIR_CLOUDS = 662       # the shapenet15k chair test split (bench.py:457-459)
SFU_RATE = 132 * 16 * 1.98e9   # expf: 16 per SM per clock, 132 SMs, 1.98 GHz


EMD_WIDE_N = 8192       # an n beyond one block's shared memory


def eval_clouds(n_clouds: int, n: int = EMD_N):
    """The test phase's two kinds of clouds at full width: synthetic shapes
    as the reference set keeps them (shape_unit), and the same shapes
    bbox-normalised as the phase leaves generated clouds."""
    from pdgn_tpu_torch.data.shapenet import SyntheticShapes
    from pdgn_tpu_torch.train.trainer import normalize_point_clouds

    ref = SyntheticShapes(size=2 * n_clouds, num_points=n).full_clouds()
    return normalize_point_clouds(ref[n_clouds:], "shape_bbox"), ref[:n_clouds]


def compare_emd_cd(a, b, label: str) -> float:
    """The kernel against its plain version on every pair of ``a`` x ``b``:
    cd rel <= 1e-5, cost rel <= 2e-3 (the kernel takes distances by direct
    differences, the plain version by the norm expansion; at level -4^7 an
    ulp of d2 moves K by ~2e-3, the JAX package's own kernel-vs-exact
    limit). Returns the largest absolute error of cd and cost."""
    import torch
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd, emd_cd_plain

    cd, cost = emd_cd(a, b)
    cd_p, cost_p = emd_cd_plain(a, b)
    e_cd, e_cost = rel(cd, cd_p), rel(cost, cost_p)
    log(f"  emd_cd {label}: cd rel {e_cd:.3e}, cost rel {e_cost:.3e}")
    require(e_cd <= 1e-5, f"emd_cd {label}: cd rel {e_cd}")
    require(e_cost <= 2e-3, f"emd_cd {label}: cost rel {e_cost}")
    require(bool(torch.isfinite(cd).all() and torch.isfinite(cost).all()),
            f"emd_cd {label}: non-finite")
    return max(max_abs(cd, cd_p), max_abs(cost, cost_p))


def culled_share(a, b) -> float:
    """The share of the culling tests (rounds 1-8) that skipped a
    sub-tile, counted by the kernel on ``a`` x ``b``."""
    import torch
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd_kernel

    counts = torch.zeros(2, device=a.device, dtype=torch.int64)
    emd_cd_kernel(a, b, counts=counts)
    seen, culled = counts.tolist()
    return culled / max(seen, 1)


def box_cull_count(a, b, pairs: int = 8):
    """The share of the row sweeps' culling tests (a warp's 256-row group
    box against a 32-column box) that pass in rounds 1-4, counted on the
    host from the kernel's own Morton order and boxes and its test
    (level * gap^2 < -110) over ``pairs`` pairs (a_i, b_{7i+3}): what the
    culling can skip, before a launch measures it."""
    import torch
    from pdgn_tpu_torch.ops.kernels.emd_cd import morton_order, tile_boxes

    a, b = a.cpu(), b.cpu()

    def boxes(x):
        x = torch.gather(x, 1, morton_order(x)[..., None].expand_as(x))
        return tile_boxes(x)

    ba, bb = boxes(a), boxes(b)
    shares = []
    for r in range(1, 5):
        level = -4.0 ** (7 - r)
        hit = tot = 0
        for i in range(pairs):
            rows = ba[i % a.shape[0]]
            cols = bb[(7 * i + 3) % b.shape[0]]
            g = rows.reshape(-1, 8, 6)        # 8 boxes of 32 rows a group
            glo, ghi = g[..., :3].amin(1), g[..., 3:].amax(1)
            gap = torch.maximum(glo[:, None] - cols[None, :, 3:],
                                cols[None, :, :3] - ghi[:, None]).clamp_min(0)
            cut = level * (gap ** 2).sum(-1) < -110.0
            hit += int(cut.sum())
            tot += cut.numel()
        shares.append(hit / tot)
    return shares


def check_emd_cd(dev) -> float:
    """Phase 2e: 2 x 4 sets at n = 2048 and 2 x 2 at n = 8192 against the
    plain version, two launches bit-identical (and equal to a launch that
    culls nothing), identical pairs cd = 0 and cost/n < 1e-3."""
    import torch
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd, emd_cd_kernel

    gen, ref = eval_clouds(4)
    a = torch.from_numpy(gen[:2]).to(dev)
    b = torch.from_numpy(ref).to(dev)
    err = compare_emd_cd(a, b, f"2x4 sets, n={EMD_N}")
    cd1, cost1 = emd_cd(a, b)
    cd2, cost2 = emd_cd(a, b)
    require(torch.equal(cd1, cd2) and torch.equal(cost1, cost2),
            "emd_cd: two launches differ")
    cd0, cost0 = emd_cd_kernel(a, b, cull=False)
    require(torch.equal(cd1, cd0) and torch.equal(cost1, cost0),
            "emd_cd: culling changed the result")
    log(f"  emd_cd culled share of the culling tests: "
        f"{culled_share(a, b):.4f}; culling keeps the bits")
    gw, rw = eval_clouds(2, EMD_WIDE_N)
    aw = torch.from_numpy(gw).to(dev)
    bw = torch.from_numpy(rw).to(dev)
    err = max(err, compare_emd_cd(aw, bw, f"2x2 sets, n={EMD_WIDE_N}"))
    log(f"  emd_cd culled share at n={EMD_WIDE_N}: "
        f"{culled_share(aw, bw):.4f}")
    del aw, bw
    cd, cost = emd_cd(b, b)
    diag_cd = torch.diagonal(cd)
    diag_emd = torch.diagonal(cost) / EMD_N
    log(f"  emd_cd identical pairs: cd {diag_cd.tolist()}, cost/n "
        f"{diag_emd.tolist()}; repeat launch bit-identical")
    require(bool((diag_cd == 0).all()), "identical pairs: cd != 0")
    require(bool((diag_emd < 1e-3).all()), "identical pairs: cost/n >= 1e-3")
    return err


# ------------------------------------------------ native oracles: phase 2n
NATIVE_CLOUDS = 4        # clouds of the kNN and FPS checks
NATIVE_K = 20
NATIVE_CENTERS = 512     # furthest_point_sample 2048 -> 512


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo``'s first processor names it: model
    name, vendor, family, model and clock (a sandbox may report the model
    name as "unknown"), and the CPU count."""
    import platform

    info: dict = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break
            key, _, value = ln.partition(":")
            info[key.strip()] = value.strip()
    keys = ("model name", "vendor_id", "cpu family", "model", "cpu MHz")
    return (", ".join(f"{k} {info[k]}" for k in keys if k in info)
            or platform.machine()) + f", {os.cpu_count()} CPUs"


def native_oracles(dev, smi: str) -> dict:
    """Phase 2n: ``knn_topk``, ``emd_cd`` and ``ops.furthest_point_sample``
    on the card against the native CPU oracles, the card's results copied
    to the host explicitly (its own generator: the later phases draw what
    they drew before)."""
    import torch
    from pdgn_tpu_torch import native
    from pdgn_tpu_torch.ops import furthest_point_sample
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd, emd_cd_plain
    from pdgn_tpu_torch.ops.kernels.knn import knn_topk, sqdist

    out = {"card": smi, "host_cpu": host_cpu()}
    t0 = time.perf_counter()
    native.library()
    out["build_s"] = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(NATIVE_CLOUDS, PO_POINTS, 3, generator=gen, device=dev)
    idx_k = knn_topk(x, x, NATIVE_K).cpu()
    xh = x.cpu()
    t0 = time.perf_counter()
    idx_n, d2_n = native.knnquery_cpu(xh, xh, NATIVE_K)
    out["knnquery_s"] = time.perf_counter() - t0
    d = sqdist(xh, xh)
    out["knn_mismatch"] = float((idx_k != idx_n).float().mean())
    out["knn_d2_max_abs"] = knn_idx_check(
        idx_k, idx_n, d, f"knn_topk (card) vs knnquery_cpu, "
        f"{NATIVE_CLOUDS} x {PO_POINTS} self, k={NATIVE_K}")
    out["knn_oracle_d2_max_abs"] = max_abs(d2_n, d.gather(-1,
                                                          idx_n.long()))

    gen_c, ref_c = eval_clouds(2)
    a, b = torch.from_numpy(gen_c), torch.from_numpy(ref_c)
    cd, cost = (v.cpu().reshape(-1) for v in emd_cd(a.to(dev), b.to(dev)))
    cd_p, cost_p = (v.cpu().reshape(-1)
                    for v in emd_cd_plain(a.to(dev), b.to(dev)))
    n = a.shape[1]
    xs = a[:, None].expand(2, 2, n, 3).reshape(4, n, 3)    # pair (i, j):
    ys = b[None].expand(2, 2, n, 3).reshape(4, n, 3)       # row i * 2 + j
    t0 = time.perf_counter()
    dl, dr = native.nndistance_cpu(xs, ys)
    out["nndistance_s"] = time.perf_counter() - t0
    cd_n = dl.double().mean(1) + dr.double().mean(1)
    t0 = time.perf_counter()
    cost_n = native.approxmatch_cpu(xs, ys)
    out["approxmatch_s"] = time.perf_counter() - t0
    out.update(cd_rel=rel(cd, cd_n), cost_rel=rel(cost, cost_n),
               plain_cd_rel=rel(cd_p, cd_n), plain_cost_rel=rel(cost_p,
                                                                 cost_n))
    log(f"  emd_cd (card) vs nndistance_cpu / approxmatch_cpu, 2x2 sets, "
        f"n={n}: cd rel {out['cd_rel']:.3e}, cost rel "
        f"{out['cost_rel']:.3e}; emd_cd_plain (card) cd rel "
        f"{out['plain_cd_rel']:.3e}, cost rel {out['plain_cost_rel']:.3e}")
    require(out["cd_rel"] <= 1e-5, f"emd_cd cd off nndistance_cpu: "
            f"rel {out['cd_rel']}")
    require(out["cost_rel"] <= 2e-3, f"emd_cd cost off approxmatch_cpu: "
            f"rel {out['cost_rel']}")

    idx_f = furthest_point_sample(x, NATIVE_CENTERS).cpu()
    t0 = time.perf_counter()
    idx_fn = native.fps_cpu(xh, NATIVE_CENTERS)
    out["fps_s"] = time.perf_counter() - t0
    diff = (idx_f != idx_fn).nonzero().tolist()
    first = min(diff, key=lambda rc: (rc[1], rc[0])) if diff else None
    out["fps_first_differing_pick"] = first
    log(f"  furthest_point_sample (card) vs fps_cpu, {NATIVE_CLOUDS} x "
        f"{PO_POINTS} -> {NATIVE_CENTERS}: {len(diff)} picks differ"
        + (f", the first at (cloud, pick) {first}: "
           f"{int(idx_f[tuple(first)])} against "
           f"{int(idx_fn[tuple(first)])}" if first else ""))
    require(first is None, f"furthest_point_sample differs from fps_cpu, "
            f"first at (cloud, pick) {first}")
    log(f"  host seconds on {out['host_cpu']}: build {out['build_s']:.2f}, "
        f"knnquery {out['knnquery_s']:.2f}, nndistance "
        f"{out['nndistance_s']:.2f}, approxmatch {out['approxmatch_s']:.2f}"
        f", fps {out['fps_s']:.2f}")
    print(json.dumps({"native_oracles": out}), flush=True)
    return out


# ------------------------------------------------ the test slice: phase 3e
def test_path(root: str, ckpt_root: str, dev) -> dict:
    """Phase 3e: ``PDGNTrainer.test`` (what ``--phase test`` runs) at full
    width on 64 synthetic clouds with the bundles phase 3t wrote, every
    launch counter set to 0 just before and read just after; then the
    matrices' 8x8 corners against the plain version, CD+EMD pairs/s, and
    the CLI's test phase in a process of its own."""
    import numpy as np
    import torch
    from pdgn_tpu_torch.data.shapenet import SyntheticShapes
    from pdgn_tpu_torch.eval.metrics import lgan_mmd_cov, pairwise_cd_emd
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd_plain
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    save_dir = os.path.join(root, "pdgn_tpu_torch", "_build", "smoke_test")
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = ExperimentConfig(batch_size=TRAIN_B, synthetic_size=TEST_CLOUDS,
                           checkpoint_dir=ckpt_root, model_dir="smoke",
                           pretrain_model_G="1_full_G.pth",
                           pretrain_model_D="1_full_D.pth",
                           save_dir=save_dir, device=dev.type)
    trainer = PDGNTrainer(cfg)
    trainer.build_model(seed=SEED + 2)
    _lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = trainer.test(tile=TEST_TILE)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    per_side = -(-TEST_CLOUDS // TEST_TILE)
    tiles = 3 * per_side * per_side
    forwards = -(-TEST_CLOUDS // TRAIN_B)
    want = {"edge_head": 4 * forwards, "slot_stats": 3 * forwards,
            "bilateral_tail_gated": 3 * forwards,
            "bilateral_tail_plain": forwards, "emd_cd": tiles}
    log(f"  test(tile={TEST_TILE}) on {TEST_CLOUDS} clouds of {EMD_N} "
        f"points: {test_s:.3f} s, launches {launches}")
    require(launches == want, f"launches {launches} != {want}")
    for k, v in res.items():
        log(f"    {k}: {v:.12f}")
    require(len(res) == 13 and all(np.isfinite(v) for v in res.values()),
            f"metrics {res}")

    (run,) = os.listdir(save_dir)
    gen = np.load(os.path.join(save_dir, run, "out.npy"))
    require(gen.shape == (TEST_CLOUDS, EMD_N, 3), f"out.npy {gen.shape}")
    ref = SyntheticShapes(size=TEST_CLOUDS, num_points=EMD_N).full_clouds()
    g = torch.from_numpy(gen).to(dev)
    r = torch.from_numpy(ref).to(dev)
    # the three matrices again (the kernel is deterministic, so these are
    # the phase's own: their MMD/COV must equal its results), timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mats = {"sample-ref": pairwise_cd_emd(g, r, TEST_TILE, device=dev),
            "ref-ref": pairwise_cd_emd(r, r, TEST_TILE, device=dev),
            "sample-sample": pairwise_cd_emd(g, g, TEST_TILE, device=dev)}
    pair_s = time.perf_counter() - t0
    pairs = 3 * TEST_CLOUDS ** 2
    pps = pairs / pair_s
    chair_min = 3 * CHAIR_CLOUDS ** 2 / pps / 60
    cd_rs, emd_rs = mats["sample-ref"]
    for name, M in (("CD", cd_rs), ("EMD", emd_rs)):
        for k, v in lgan_mmd_cov(M.T).items():
            require(v == res[f"{k}-{name}"], f"{k}-{name}: the matrices "
                    "are not the phase's")
    sets = {"sample": g, "ref": r}
    err = 0.0
    for name, (cd, emd) in mats.items():
        s_name, r_name = name.split("-")
        cd_p, cost_p = emd_cd_plain(sets[s_name][:8], sets[r_name][:8])
        cd_k = torch.from_numpy(cd[:8, :8])
        emd_k = torch.from_numpy(emd[:8, :8])
        emd_p = cost_p.cpu() / EMD_N
        e_cd, e_emd = rel(cd_k, cd_p.cpu()), rel(emd_k, emd_p)
        log(f"  {name} 8x8 corner vs plain: cd rel {e_cd:.3e}, emd rel "
            f"{e_emd:.3e}")
        require(e_cd <= 1e-5 and e_emd <= 2e-3, f"{name} corner disagrees")
        err = max(err, max_abs(cd_k, cd_p.cpu()), max_abs(emd_k, emd_p))
    log(f"  CD+EMD pairs/s: {pps:.1f} ({pairs} pairs in {pair_s:.3f} s, "
        f"tile {TEST_TILE}); estimated full chair evaluation on this card "
        f"(3 x {CHAIR_CLOUDS}^2 pairs): {chair_min:.3f} min")

    # the module entry in a process of its own: the one run of
    # python -m pdgn_tpu_torch.cli in this script (3bt and 3d call
    # cli.main in process)
    cmd = [sys.executable, "-m", "pdgn_tpu_torch.cli", "--network",
           "PDGNet_v2", "--model_dir", "smoke", "--phase", "test",
           "--dataset", "synthetic", "--checkpoint_dir", ckpt_root,
           "--pretrain_model_G", "1_full_G.pth", "--pretrain_model_D",
           "1_full_D.pth", "--save_dir", os.path.join(save_dir, "cli"),
           "--device", dev.type]
    del trainer, g, r
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=300)
    cli_s = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    lines = [ln for ln in out.splitlines() if "::test::INFO] " in ln
             and ": " in ln.split("] ", 1)[1]]
    log(f"  python -m pdgn_tpu_torch.cli --phase test --dataset synthetic: "
        f"exit {proc.returncode} in {cli_s:.1f} s, {len(lines)} log lines")
    for ln in lines[-13:]:
        log(f"    {ln}")
    require(proc.returncode == 0 and " [*] Load SUCCESS" in out
            and " [*] Test finished!" in out and "jsd: " in out,
            f"the CLI's test phase failed:\n{out[-3000:]}")
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"launches": launches, "seconds": test_s, "metrics": res,
            "pairs_per_s": pps, "pairs": pairs, "pairwise_s": pair_s,
            "chair_eval_min": chair_min, "corner_max_abs_err": err,
            "cli_seconds": cli_s}


# ------------------------------------------------ the test slice: phase 4e
def emd_bound(S: int, R: int, n: int):
    """Least time of the fused CD + approxmatch on S x R pairs: a distance
    once (8 FLOP) and ~8 FLOP an element in each of the 9 rounds at 67
    TFLOP/s, or three expf an element (exponent chaining) at the special
    function units' rate, whichever is longer; bytes: both sets in, two
    floats a pair out."""
    elems = float(S * R) * n * n
    t_fma = 80.0 * elems / PEAK_FLOPS * 1e3
    t_exp = 3.0 * elems / SFU_RATE * 1e3
    t_mem = 4.0 * ((S + R) * n * 3 + 2 * S * R) / PEAK_BYTES * 1e3
    t_ops = max(t_fma, t_exp)
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def time_emd_cd(dev) -> dict:
    """Phase 4e: the kernel on one 64x64 tile and one 8x8 tile of the test
    path's clouds, beside the bound; the plain version on an 8x8 tile
    (per pair) and on the 64x64 tile's pairs in 8x8 blocks (the plain
    version cannot hold a 64x64 tile's distances: 64 GB)."""
    import torch
    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd, emd_cd_plain

    from pdgn_tpu_torch.ops.kernels.emd_cd import emd_cd_kernel

    gen, ref = eval_clouds(TEST_TILE)
    a = torch.from_numpy(gen).to(dev)
    b = torch.from_numpy(ref).to(dev)
    ms64 = time_ms(lambda: emd_cd(a, b), 2)
    ms64_all = time_ms(lambda: emd_cd_kernel(a, b, cull=False), 1)
    share = culled_share(a, b)
    counted = box_cull_count(a, b)
    log(f"  emd_cd 64x64 tile: culling off {ms64_all:.3f} ms; culled share "
        f"of the culling tests {share:.4f}; by the box count, the row "
        f"sweeps' tests that pass in rounds 1-4: "
        f"{[round(c, 4) for c in counted]}")
    ms8 = time_ms(lambda: emd_cd(a[:8], b[:8]), 5)
    plain8 = time_ms(lambda: emd_cd_plain(a[:8], b[:8]), 2)

    def plain_tile():
        for i in range(0, TEST_TILE, 8):
            for j in range(0, TEST_TILE, 8):
                emd_cd_plain(a[i:i + 8], b[j:j + 8])

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_tile()
    end.record()
    torch.cuda.synchronize()
    plain64 = start.elapsed_time(end)
    b64, by = emd_bound(TEST_TILE, TEST_TILE, EMD_N)
    b8, _ = emd_bound(8, 8, EMD_N)
    pairs = TEST_TILE * TEST_TILE
    log(f"  emd_cd 64x64 tile: {ms64:.3f} ms ({ms64 / pairs * 1e3:.3f} us a "
        f"pair), bound {b64:.3f} ms ({by}); 8x8 tile: {ms8:.3f} ms, bound "
        f"{b8:.3f} ms; plain 8x8: {plain8:.3f} ms ({plain8 / 64:.3f} ms a "
        f"pair), plain over the 64x64 tile's pairs: {plain64:.3f} ms")
    err = compare_emd_cd(a[:8], b[:8], "8x8 tile of the timed sets")
    gw, rw = eval_clouds(2, EMD_WIDE_N)
    aw = torch.from_numpy(gw).to(dev)
    bw = torch.from_numpy(rw).to(dev)
    msw = time_ms(lambda: emd_cd(aw, bw), 2)
    bw_ms, _ = emd_bound(2, 2, EMD_WIDE_N)
    log(f"  time emd_cd 2x2 pairs at n={EMD_WIDE_N}: {msw:.3f} ms, bound "
        f"{bw_ms:.3f} ms")
    return {"ms": ms64, "plain_ms": plain64, "bound_ms": b64,
            "bound_by": by, "library_ms": None, "max_abs_err": err,
            "ms_8x8": ms8, "bound_ms_8x8": b8, "plain_ms_8x8": plain8,
            "plain_ms_per_pair": plain8 / 64, "ms_no_cull": ms64_all,
            "culled_share": share, "box_cull_count_rounds_1_4": counted,
            f"ms_2x2_n{EMD_WIDE_N}": msw,
            "shape": f"{TEST_TILE}x{TEST_TILE} pairs of {EMD_N}-point clouds "
                     f"(plain: 64 tiles of 8x8)"}


# ------------------------------------------------ the data slice: phase 3d
DATA_LONG_BATCHES = 130  # the loader's timed epoch, about the real chair
                         # train split's batches at B=35
STANDIN_STEP_MS = 20.0   # device time of the step the loader feeds there
# batches of each stand-in epoch read (the first quarter of the epoch: the
# bf16 phases' seconds come out of these, so that the run stays within its
# time before them)
DATA_STANDIN_BATCHES = 33


def _metric_lines(run_dir: str) -> dict:
    """The ``"%s: %.12f"`` result lines of a test phase's log."""
    out = {}
    with open(os.path.join(run_dir, "log.txt")) as f:
        for ln in f:
            body = ln.split("::test::INFO] ", 1)[-1].strip()
            name, _, value = body.partition(": ")
            try:
                out[name] = float(value)
            except ValueError:
                continue
    return out


def _tensors_equal(x, y) -> bool:
    import torch

    return (x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.cpu(), y.cpu()))


def _states_equal(a, b) -> bool:
    """Every parameter, buffer, Adam moment and step of two GANStates."""
    for ma, mb in zip((a.generator,) + a.discriminators,
                      (b.generator,) + b.discriminators):
        sa, sb = ma.state_dict(), mb.state_dict()
        if sa.keys() != sb.keys() or not all(_tensors_equal(sa[k], sb[k])
                                             for k in sa):
            return False
    for oa, ob in zip((a.g_opt,) + a.d_opts, (b.g_opt,) + b.d_opts):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        if sa.keys() != sb.keys():
            return False
        for i in sa:
            if sa[i].keys() != sb[i].keys() or not all(
                    _tensors_equal(sa[i][k], sb[i][k]) for k in sa[i]):
                return False
    return True


def data_path(root: str, smi: str, dev) -> dict:
    """Phase 3d: the hdf5 reader, the pinned loader and the CLI's
    shapenet15k train, msgpack round trip, resume and test."""
    import math

    import numpy as np
    import torch
    from pdgn_tpu_torch import cli
    from pdgn_tpu_torch.data import (ShapeNetCore, batch_iterator, h5,
                                     train_loader)
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train import checkpoint as ckpt_lib
    from pdgn_tpu_torch.train.trainer import PDGNTrainer

    sys.path.insert(0, os.path.join(root, "tests"))
    import torch_h5_fixture as fx

    work = os.path.join(root, "pdgn_tpu_torch", "_build", "smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        path = os.path.join(work, "shapenet.hdf5")
        clouds = fx.write_shapenet(path, SEED)
        with h5.File(path) as f:
            for syn, splits in clouds.items():
                for split, want in splits.items():
                    got = f[syn][split][...]
                    require(got.dtype == want.dtype
                            and np.array_equal(got, want),
                            f"{syn}/{split} read back differs")
            train, test = f[fx.CHAIR]["train"], f[fx.CHAIR]["test"]
            require(train.chunks is None and test.chunks == fx.TEST_CHUNKS
                    and test.compression == "gzip" and test.shuffle,
                    "the file's layouts are not the ones written")
        log(f"  {os.path.getsize(path)} bytes written and read back equal "
            f"(chair train contiguous, test chunked {fx.TEST_CHUNKS} "
            "shuffle+deflate)")

        dset = ShapeNetCore(path, "chair", "train", "shape_unit")
        np.random.seed(SEED)
        host = list(batch_iterator(dset, TRAIN_B))
        np.random.seed(SEED)
        got = list(train_loader(dset, TRAIN_B, device=dev))
        require(len(got) == len(host) and all(
            all(torch.equal(torch.from_numpy(a), b.cpu())
                for a, b in zip(h[:4], d[:4])) and h[4] == d[4]
            for h, d in zip(host, got)),
            "a loader batch differs from the host batch")
        del got
        loader = loader_times(work, smi, dev)

        ckpt = os.path.join(work, "ckpt")
        prof = os.path.join(work, "prof")
        base = ["--network", "PDGNet_v2", "--model_dir", "smoke",
                "--dataset", "shapenet15k", "--data_root", path,
                "--choice", "chair", "--batch_size", str(TRAIN_B),
                "--checkpoint_dir", ckpt,
                "--save_dir", os.path.join(work, "results")]
        steps = len(dset) // TRAIN_B
        _lib.LAUNCHES.clear()
        trainer = cli.main(base + ["--phase", "train", "--max_epoch", "1",
                                   "--profile_dir", prof])
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        ran = len(trainer.step_seconds)
        log(f"  cli --phase train --dataset shapenet15k --choice chair: "
            f"{ran} steps at B={TRAIN_B}, launches {launches}")
        require(ran == steps, f"{ran} steps ran, {steps} expected")
        want = {k: v * steps for k, v in PER_STEP.items()}
        require(launches == want, f"launches {launches} != {want}")
        m = trainer.last_metrics
        require(len(m) == 6 and all(math.isfinite(v) for v in m.values()),
                f"losses {m}")
        traces = os.listdir(prof) if os.path.isdir(prof) else []
        require(any(t.endswith(".json") for t in traces),
                f"no trace under {prof}: {traces}")
        require(os.path.isfile(os.path.join(ckpt, "smoke", "generator.py")),
                "the generator source was not copied")
        paths = ckpt_lib.save(trainer.ckpt_dir, trainer.state, 1, "chair",
                              fmt="msgpack")
        fresh = PDGNTrainer(trainer.cfg)
        fresh.build_model(seed=SEED + 3)
        epoch = ckpt_lib.load(*paths, fresh.state)
        require(epoch == 1 and _states_equal(trainer.state, fresh.state),
                "the msgpack round trip is not exact")
        log(f"  msgpack bundles {[os.path.getsize(p) for p in paths]} "
            "bytes: every parameter, buffer, Adam moment and step equal "
            "after the round trip")
        # the trainer's own .pth pair through the converter command, in a
        # process of its own
        pth = [os.path.join(trainer.ckpt_dir, f"1_chair_{s}.pth")
               for s in "GD"]
        conv_dir = os.path.join(work, "converted")
        converted = [os.path.join(conv_dir, f"1_chair_{s}.msgpack")
                     for s in "GD"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pdgn_tpu_torch.convert_ckpt", "--ckpt_g",
             pth[0], "--ckpt_d", pth[1], "--out_dir", conv_dir,
             "--category", "chair"], cwd=root, capture_output=True,
            text=True, timeout=600)
        convert_s = time.perf_counter() - t0
        require(proc.returncode == 0 and proc.stdout.split() == converted,
                f"the converter failed:\n"
                f"{(proc.stdout + proc.stderr)[-3000:]}")
        log(f"  python -m pdgn_tpu_torch.convert_ckpt 1_chair_{{G,D}}.pth "
            f"({[os.path.getsize(p) for p in pth]} bytes): "
            f"{[os.path.getsize(p) for p in converted]} bytes of msgpack in "
            f"{convert_s:.1f} s")
        del trainer, fresh
        torch.cuda.empty_cache()

        resume = ["--pretrain_model_G", "1_chair_G.msgpack",
                  "--pretrain_model_D", "1_chair_D.msgpack"]
        _lib.LAUNCHES.clear()
        again = cli.main(base + ["--phase", "train", "--max_epoch", "2"]
                         + resume)
        torch.cuda.synchronize()
        resumed = dict(_lib.LAUNCHES)
        ran2 = len(again.step_seconds)
        want2 = {k: v * 2 * steps for k, v in PER_STEP.items()}
        require(ran2 == 2 * steps and resumed == want2,
                f"resume: {ran2} steps, launches {resumed}")
        require(all(math.isfinite(v) for v in again.last_metrics.values()),
                f"resume losses {again.last_metrics}")
        log(f"  resumed from 1_chair_*.msgpack to --max_epoch 2: {ran2} "
            f"steps, launches {resumed}")
        # the wait share over the resume's steps, none under the profiler:
        # all of them, and without each epoch's first batch
        w, st = again.wait_seconds, again.step_seconds
        later = [i for i in range(ran2) if i % steps]
        wait, step = sum(w), sum(st)
        share = wait / (wait + step)
        lw, ls = sum(w[i] for i in later), sum(st[i] for i in later)
        later_share = lw / (lw + ls)
        firsts = [w[i] for i in range(0, ran2, steps)]
        log(f"  consumer blocked in the loader {wait:.6f} s of "
            f"{wait + step:.6f} s step wall time over the resume's {ran2} "
            f"steps (no profiler): share {share:.6f}; without each epoch's "
            f"first batch (waits {firsts}) {later_share:.6f}; per step "
            f"{w} on {smi}")
        del again
        torch.cuda.empty_cache()

        _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        cli.main(base + ["--phase", "test"] + resume)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = dict(_lib.LAUNCHES)
        (run,) = os.listdir(os.path.join(work, "results"))
        run = os.path.join(work, "results", run)
        out = np.load(os.path.join(run, "out.npy"))
        lines = _metric_lines(run)
        log(f"  cli --phase test --dataset shapenet15k --choice chair: "
            f"{test_s:.3f} s, out.npy {out.shape}, launches {test_launches}")
        for k, v in lines.items():
            log(f"    {k}: {v:.12f}")
        want_out = (len(clouds[fx.CHAIR]["test"]), EMD_N, 3)
        require(out.shape == want_out and bool(np.isfinite(out).all()),
                f"out.npy {out.shape}, {want_out} expected")
        require(len(lines) == 13 and all(math.isfinite(v)
                                         for v in lines.values()),
                f"metric lines {lines}")
        # the same test phase from the .pth pair and from the converted
        # msgpack pair: the same weights (the layout maps are permutations)
        # and seed, so the same bits; their launches are not the path's
        for tag, pair in (("pth", pth), ("converted", converted)):
            save_dir = os.path.join(work, f"results_{tag}")
            _lib.LAUNCHES.clear()
            cli.main(base + ["--phase", "test", "--save_dir", save_dir,
                             "--pretrain_model_G", pair[0],
                             "--pretrain_model_D", pair[1]])
            torch.cuda.synchronize()
            again_launches = dict(_lib.LAUNCHES)
            (run_t,) = os.listdir(save_dir)
            got = _metric_lines(os.path.join(save_dir, run_t))
            got_out = np.load(os.path.join(save_dir, run_t, "out.npy"))
            same = (got == lines and np.array_equal(got_out, out)
                    and again_launches == test_launches)
            log(f"  cli --phase test from the {tag} pair: the 13 metric "
                f"lines, out.npy and the launches equal the msgpack run's: "
                f"{same}")
            require(same, f"the test phase from the {tag} pair differs: "
                    f"{got} {again_launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    total: dict = {}
    for d in (launches, resumed, test_launches):
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return {"launches": total, "loader": loader, "wait_share": share,
            "wait_share_after_first": later_share,
            "first_batch_waits": firsts,
            "wait_seconds": wait, "step_seconds": step,
            "test_seconds": test_s, "metrics": lines,
            "convert_seconds": convert_s}


def _standin_epoch(batches, dev, cycles: int, copy: bool, limit: int):
    """The first ``limit`` batches of an epoch read by a stand-in step: a
    device sleep of ``cycles`` and a sum of each cloud tensor, synchronised
    every step as the trainer's metrics are. ``copy``: the batch is on the
    host and is copied to the card here, synchronously. Closes the loader;
    returns (wall s, s blocked on the batch)."""
    import torch

    acc = torch.zeros((), device=dev)
    blocked = 0.0
    t0 = time.perf_counter()
    for _ in range(limit):
        tw = time.perf_counter()
        b = next(batches, None)
        if b is None:
            break
        if copy:
            b = [x.to(dev) for x in b[:4]]
        blocked += time.perf_counter() - tw
        torch.cuda._sleep(cycles)
        for x in b[:4]:
            acc += x.sum()
        float(acc)
    wall = time.perf_counter() - t0
    batches.close()
    return wall, blocked


def loader_times(work: str, smi: str, dev) -> dict:
    """The loader over one epoch of ``DATA_LONG_BATCHES`` batches of 35
    chairs (a contiguous train split written from a seed): alone, against
    the host batches alone, and over the first ``DATA_STANDIN_BATCHES``
    of an epoch under a stand-in step of ``STANDIN_STEP_MS`` against a
    plain copy in the consumer after the same threaded host prefetch
    (pinned ring, plain, plain, pinned ring)."""
    import numpy as np
    import torch
    from pdgn_tpu_torch.data import ShapeNetCore, batch_iterator, train_loader

    import torch_h5_fixture as fx

    path = os.path.join(work, "long.hdf5")
    fx.write_shapenet(path, SEED + 1, splits={
        fx.CHAIR: {"train": DATA_LONG_BATCHES * TRAIN_B, "val": 1,
                   "test": fx.TEST_CHUNKS[0]}})
    dset = ShapeNetCore(path, "chair", "train", "shape_unit")
    np.random.seed(SEED)
    t0 = time.perf_counter()
    n_host = sum(1 for _ in batch_iterator(dset, TRAIN_B))
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    first, n = None, 0
    t0 = time.perf_counter()
    for _batch in train_loader(dset, TRAIN_B, device=dev):
        first = time.perf_counter() - t0 if first is None else first
        n += 1
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    require(n == n_host == DATA_LONG_BATCHES, f"{n}, {n_host} batches")
    bps = n / loader_s
    log(f"  train_loader(ShapeNetCore chair train, {TRAIN_B}) alone, one "
        f"epoch: {bps:.3f} batches/s ({n} batches in {loader_s:.4f} s, the "
        f"first after {first:.6f} s; the host batches alone, "
        f"batch_iterator: {n_host / host_s:.3f} batches/s) on {smi}")

    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    cycles = int(10 ** 7 * STANDIN_STEP_MS / start.elapsed_time(end))
    runs = {"pinned": [], "plain": []}
    for kind in ("pinned", "plain", "plain", "pinned"):
        pinned = kind == "pinned"
        wall, blocked = _standin_epoch(
            train_loader(dset, TRAIN_B, device=dev if pinned else "cpu"),
            dev, cycles, copy=not pinned, limit=DATA_STANDIN_BATCHES)
        runs[kind].append({"wall_s": wall, "blocked_s": blocked})
        log(f"  under a {STANDIN_STEP_MS} ms stand-in step, {kind} "
            f"{'ring' if pinned else 'copy in the consumer'}: "
            f"{DATA_STANDIN_BATCHES} batches in {wall:.6f} s, consumer "
            f"blocked {blocked:.6f} s on {smi}")
    shutil.rmtree(os.path.join(work, "long_stats"), ignore_errors=True)
    os.remove(path)
    return {"batches_per_s": bps, "batches": n, "seconds": loader_s,
            "first_batch_s": first, "host_batches_seconds": host_s,
            "standin_step_ms": STANDIN_STEP_MS,
            "standin_batches": DATA_STANDIN_BATCHES, "standin": runs}


# ----------------------------------------- the point-ops slice: phase 2p
PO_B = 35                # clouds of the point-ops path (generate() at B=35)
PO_POINTS = 2048
PO_CENTERS = 512         # furthest_point_sample 2048 -> 512
PO_ROWS = 1024           # the generator's stage-4 points (edge features)


def knn_idx_check(idx_k, idx_p, d, label: str) -> float:
    """A kernel's kNN indices against its plain version's: equal except at
    near-ties (every mismatched neighbour's distance ``d`` within 1e-5
    relative of the one it replaces, at most 0.1% of the entries; phase
    2's rule). Returns the largest absolute difference of the selected
    distances (0 where the indices agree)."""
    import torch

    mism = idx_k != idx_p
    frac = float(mism.float().mean())
    dk = d.gather(-1, idx_k.long())
    dp = d.gather(-1, idx_p.long())
    gap = 0.0
    if bool(mism.any()):
        scale = torch.maximum(dk.abs(), dp.abs()).clamp_min(1e-12)
        gap = float(((dk - dp).abs() / scale)[mism].max())
    log(f"  {label}: idx mismatch {frac:.6f} ({int(mism.sum())} entries, "
        f"max near-tie gap {gap:.3e})")
    require(frac <= 1e-3, f"{label}: {frac} of idx differ")
    require(gap <= 1e-5, f"{label}: idx differ beyond near-ties")
    return max_abs(dk, dp)


def compare_knn_topk(q, db, k: int, label: str) -> float:
    """``knn_topk`` against ``knn_topk_reference`` on the same inputs; for
    C <= 4 both round every step alike, so the indices must be equal."""
    import torch
    from pdgn_tpu_torch.ops.kernels.knn import (knn_topk, knn_topk_reference,
                                                sqdist)

    idx_k = knn_topk(q, db, k)
    idx_p = knn_topk_reference(q, db, k)
    torch.cuda.synchronize()
    if q.shape[-1] <= 4:
        require(torch.equal(idx_k, idx_p), f"knn_topk {label}: C <= 4 idx "
                "differ from the plain version")
    return knn_idx_check(idx_k, idx_p, sqdist(q, db),
                         f"knn_topk {label}")


def compare_knn_gather(x, k: int, label: str) -> float:
    """``knn_gather`` against its plain version: idx by the near-tie rule,
    nbr bit-equal to ``grouping(x, idx)``, the gradient of sum(nbr^2) rel
    <= 1e-5 of the plain version's for the same graph (both scatter-add
    with float atomics). Returns the largest absolute error of the
    selected distances and the gradient."""
    import torch
    from pdgn_tpu_torch.ops.grouping import grouping
    from pdgn_tpu_torch.ops.kernels.knn import (knn_gather,
                                                knn_topk_reference, sqdist)

    x = x.detach().clone().requires_grad_(True)
    idx, nbr = knn_gather(x, k)
    with torch.no_grad():
        idx_p = knn_topk_reference(x, x, k + 1)[..., 1:]
        err = knn_idx_check(idx, idx_p, sqdist(x, x), f"knn_gather {label}")
        require(torch.equal(nbr, grouping(x, idx)),
                f"knn_gather {label}: nbr != grouping(x, idx)")
    (g_k,) = torch.autograd.grad((nbr ** 2).sum(), x)
    (g_p,) = torch.autograd.grad((grouping(x, idx) ** 2).sum(), x)
    e = rel(g_k, g_p)
    log(f"  knn_gather {label}: nbr bit-equal to grouping(x, idx); "
        f"d(sum nbr^2)/dx rel {e:.3e}")
    require(e <= 1e-5, f"knn_gather {label}: gradient rel {e}")
    return max(err, max_abs(g_k, g_p))


def check_knn_kernels(gen, dev) -> dict:
    """Phase 2p at B=8: ``knn_topk`` for C in {3, 256} and k in {20, 64,
    128}, queries other than the database (512 centers in 2048 points at
    C=3, 1024 rows against 1024 at C=256), then self queries on clouds
    whose every point appears twice (ties: the lower index first, so each
    row's first two neighbours are the pair, in order); ``knn_gather`` at
    C=128, k=10."""
    import torch
    from pdgn_tpu_torch.ops.kernels.knn import knn_topk

    B = 8
    err = 0.0
    for C, M, N in ((3, PO_CENTERS, PO_POINTS), (256, PO_ROWS, PO_ROWS)):
        q = torch.randn(B, M, C, generator=gen, device=dev)
        db = torch.randn(B, N, C, generator=gen, device=dev)
        for k in (20, 64, 128):
            err = max(err, compare_knn_topk(q, db, k, f"C={C} {M}->{N} "
                                            f"k={k} B={B}"))
        dup = db.clone()
        dup[:, 1::2] = dup[:, 0::2]
        err = max(err, compare_knn_topk(dup, dup, 20, f"C={C} self, every "
                                        f"point twice, k=20 B={B}"))
        idx = knn_topk(dup, dup, 20)
        pair = torch.arange(N, device=dev) // 2 * 2
        require(torch.equal(idx[..., 0].long(), pair.expand(B, N))
                and torch.equal(idx[..., 1].long(), pair.expand(B, N) + 1),
                f"knn_topk C={C}: a duplicated pair is not first, in order")
    err = max(err, compare_knn_topk(*head_graph_input(B, gen, dev), K + 1,
                                    f"the head's graph, C=128+128, k={K + 1} "
                                    f"B={B}"))
    x = torch.randn(B, PO_ROWS, 128, generator=gen, device=dev)
    return {"knn_topk": err,
            "knn_gather": compare_knn_gather(x, K, f"C=128 k={K} B={B}")}


def head_graph_input(B: int, gen, dev):
    """The stage-4 head's kNN input: ``[xs broadcast | x]``, 1024 points of
    128 + 128 channels (the xs half constant over a cloud)."""
    import torch

    n, c, cx, _, _ = stage_dims(4)
    x = torch.randn(B, n, c, generator=gen, device=dev)
    xs = torch.randn(B, 1, cx, generator=gen, device=dev)
    q = torch.cat([xs.expand(B, n, cx), x], dim=-1).contiguous()
    return q, q


# ----------------------------------------- the point-ops slice: phase 3p
PO_PER_PATH = {"knn_topk": 6, "knn_gather": 1}
PO_REPS = 5              # warm passes timed for the path's wall time


def point_ops_path(model, gen, dev) -> dict:
    """Phase 3p: 35 clouds of 2048 points from ``generate()`` (the
    full-width generator, B=35), then the public ``pdgn_tpu_torch.ops`` API
    with every launch counter set to 0 just before and read just after:
    FPS 2048 -> 512 and ``gather_points``; ``group_xyz`` (k=20, the shape
    loss's neighbourhoods); ``query_and_group`` by ball (r=0.2) and by kNN
    (32); ``query_and_group_dilate`` (32 of 64 self neighbours);
    ``three_nn`` + ``interpolate`` 512 -> 2048; ``edge_features`` and
    ``edge_features_xyz`` at (35, 1024, 256), k=10; ``neighbor_features`` at
    (35, 1024, 128), k=10; ``EdgeConv(128, 256, 10)`` forward and backward.
    Then holds every kernel result against its plain version (the kernels
    are deterministic, so a second launch gives the path's indices)."""
    import numpy as np
    import torch
    from pdgn_tpu_torch import ops
    from pdgn_tpu_torch.models.generator import EdgeConv
    from pdgn_tpu_torch.ops.edges import neighbor_idx
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.ops.kernels.knn import knn_topk_reference, sqdist
    from pdgn_tpu_torch.train.generate import generate

    clouds = generate(PO_B, PO_B, SEED + 3, device=dev, model=model)
    require(clouds.shape == (PO_B, PO_POINTS, 3)
            and bool(np.isfinite(clouds).all()), "generated clouds")
    xyz = torch.from_numpy(clouds).to(dev)
    fea = torch.randn(PO_B, PO_POINTS, 32, generator=gen, device=dev)
    x256 = torch.randn(PO_B, PO_ROWS, 256, generator=gen, device=dev)
    x128 = torch.randn(PO_B, PO_ROWS, 128, generator=gen, device=dev)
    pc = xyz[:, :PO_ROWS].contiguous()
    conv = EdgeConv(128, 256, K).to(dev)
    ct = torch.randn(PO_B, PO_ROWS, 256, generator=gen, device=dev)

    def run():
        slots = torch.Generator(device=dev).manual_seed(SEED)
        x_in = x128.clone().requires_grad_(True)
        fps = ops.furthest_point_sample(xyz, PO_CENTERS)
        centers = ops.gather_points(xyz, fps)
        shape_nbrs = ops.group_xyz(xyz, centers, nsample=20)
        ball = ops.query_and_group(xyz, centers, fea, nsample=32, radius=0.2)
        knn32 = ops.query_and_group(xyz, centers, fea, nsample=32)
        dilated = ops.query_and_group_dilate(xyz, None, fea, nsample=32,
                                             generator=slots)
        dist3, idx3 = ops.three_nn(xyz, centers)
        up = ops.interpolate(ops.gather_points(fea, fps), idx3,
                             ops.three_interpolate_weights(dist3))
        e_fea = ops.edge_features(x256, K)
        e_fea2, e_xyz = ops.edge_features_xyz(x256, pc, K)
        nb_idx, nbr = ops.neighbor_features(x128, K)
        y = conv(x_in)
        y.backward(ct)
        return (fps, centers, shape_nbrs, ball, knn32, dilated, up, e_fea,
                e_fea2, e_xyz, nb_idx, nbr, y, x_in)

    torch.cuda.synchronize()
    _lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    (fps, centers, shape_nbrs, ball, knn32, dilated, up, e_fea, e_fea2,
     e_xyz, nb_idx, nbr, y, x_in) = res
    log(f"  point-ops path on {PO_B} clouds of {PO_POINTS} points: first "
        f"(cold) pass {cold:.3f} s, launches {launches}")
    require(launches == PO_PER_PATH, f"launches {launches} != {PO_PER_PATH}")

    # FPS is plain torch: the card's picks equal the CPU's on cloud 0
    want_fps = ops.furthest_point_sample(xyz[:1].cpu(), PO_CENTERS)
    require(torch.equal(fps[:1].cpu(), want_fps), "FPS differs from the CPU")
    shapes = {"group_xyz": (shape_nbrs, (PO_B, PO_CENTERS, 20, 3)),
              "ball": (ball, (PO_B, PO_CENTERS, 32, 35)),
              "knn32": (knn32, (PO_B, PO_CENTERS, 32, 35)),
              "dilate": (dilated, (PO_B, PO_POINTS, 32, 35)),
              "interpolate": (up, (PO_B, PO_POINTS, 32)),
              "edge_features": (e_fea, (PO_B, PO_ROWS, K, 512)),
              "edge_features_xyz": (e_xyz, (PO_B, PO_ROWS, K, 6)),
              "neighbor_features": (nbr, (PO_B, PO_ROWS, K, 128)),
              "edge_conv": (y, (PO_B, PO_ROWS, 256)),
              "edge_conv d x": (x_in.grad, (PO_B, PO_ROWS, 128))}
    for name, (v, shape) in shapes.items():
        require(tuple(v.shape) == shape and bool(torch.isfinite(v).all()),
                f"{name}: shape {tuple(v.shape)} or non-finite")
    require(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                for p in conv.parameters()), "EdgeConv: parameter gradients")

    # each kernel call of the path against its plain version
    err = 0.0
    for label, q, db, k, out, regroup in (
            ("group_xyz k=20", centers, xyz, 20, shape_nbrs,
             lambda i: ops.grouping(xyz, i)),
            ("query_and_group k=32", centers, xyz, 32, knn32,
             lambda i: ops.query_and_group(xyz, centers, fea, i)),
            ("dilate self k=64", xyz, xyz, 64, None, None)):
        idx_k = ops.knn(db, q, k)
        err = max(err, knn_idx_check(idx_k, knn_topk_reference(q, db, k),
                                     sqdist(q, db), f"3p {label}"))
        if out is not None:
            require(torch.equal(out, regroup(idx_k)), f"3p {label}: the "
                    "path's output is not its graph's grouping")
    idx_e = neighbor_idx(x256, K)
    err = max(err, knn_idx_check(
        idx_e, knn_topk_reference(x256, x256, K + 1)[..., 1:],
        sqdist(x256, x256), f"3p edge_features C=256 k={K}"))
    nb = ops.grouping(x256, idx_e)
    central = x256[:, :, None, :].expand_as(nb)
    require(torch.equal(e_fea, torch.cat([central, nb - central], -1))
            and torch.equal(e_fea2, e_fea), "3p edge features")
    err_g = knn_idx_check(nb_idx,
                          knn_topk_reference(x128, x128, K + 1)[..., 1:],
                          sqdist(x128, x128),
                          f"3p neighbor_features C=128 k={K}")
    require(torch.equal(nbr, ops.grouping(x128, nb_idx)),
            "3p neighbor_features: nbr != grouping(x, idx)")
    require(torch.equal(neighbor_idx(x128, K), nb_idx),
            "3p: knn_topk and knn_gather build different graphs")
    log("  3p outputs: every kernel graph held to its plain version; "
        "FPS equal to the CPU's; all outputs finite")

    # the path's wall time: the median of PO_REPS warm passes
    del res, fps, shape_nbrs, ball, knn32, dilated, up, e_fea, e_fea2, e_xyz
    del nbr, y, x_in
    walls = []
    for _ in range(PO_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[PO_REPS // 2]
    log(f"  point-ops path wall: median {wall:.4f} s of {PO_REPS} warm "
        f"passes {[round(w, 4) for w in walls]}; cold pass {cold:.4f} s")
    return {"launches": launches, "seconds": wall, "walls": walls,
            "cold_seconds": cold,
            "max_abs_err": {"knn_topk": err, "knn_gather": err_g},
            "inputs": {"xyz": xyz, "centers": centers, "x256": x256,
                       "x128": x128}}


# ----------------------------------------- the point-ops slice: phase 4p
def knn_bound(B: int, M: int, N: int, C: int, k: int, self_query: bool,
              gather: bool = False):
    """Least time of a kNN call: per (query, row) pair 3C operations for
    C <= 4 (C differences, C products, C-1 sums, one compare) or 2C + 4
    (the dot product's FMAs at 2 FLOP, the expansion's three, one compare)
    plus the norms; bytes: each input once, idx (and nbr) once."""
    pairs = float(B) * M * N
    if C <= 4:
        flops = 3.0 * C * pairs
    else:
        flops = (2.0 * C + 4) * pairs + 2.0 * C * B * (M + (0 if self_query
                                                           else N))
    nbytes = 4.0 * (B * M * C + (0 if self_query else B * N * C)
                    + B * M * k + (B * M * k * C if gather else 0))
    return bound(flops, nbytes)


def time_knn(inputs, dev) -> dict:
    """Phase 4p: ``knn_topk`` at the three 3p shapes and ``knn_gather`` at
    (35, 1024, 128), k=10, beside the plain version, the two PyTorch calls
    ``torch.cdist`` + ``torch.topk(largest=False)`` (a yardstick, not one
    call; the gather adds ``grouping``), and the bound; holds the kernel
    to its plain version on the timed inputs."""
    import torch
    from pdgn_tpu_torch.ops.grouping import grouping
    from pdgn_tpu_torch.ops.kernels.knn import (knn_gather,
                                                knn_gather_reference,
                                                knn_topk, knn_topk_reference)

    xyz, centers = inputs["xyz"], inputs["centers"]
    x256, x128 = inputs["x256"], inputs["x128"]
    rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "cdist_topk_ms": 0.0, "bound_ms": 0.0}
    err = 0.0
    for label, q, db, k, self_query in (
            (f"{PO_B}x{PO_CENTERS} -> {PO_POINTS}, C=3, k=20", centers, xyz,
             20, False),
            (f"{PO_B}x{PO_POINTS} self, C=3, k=64", xyz, xyz, 64, True),
            (f"{PO_B}x{PO_ROWS} self, C=256, k={K + 1}", x256, x256, K + 1,
             True)):
        B, M, C = q.shape
        b, by = knn_bound(B, M, db.shape[1], C, k, self_query)
        row = {"shape": label,
               "ms": time_ms(lambda: knn_topk(q, db, k), 10),
               "plain_ms": time_ms(lambda: knn_topk_reference(q, db, k), 2),
               "cdist_topk_ms": time_ms(lambda: torch.topk(
                   torch.cdist(q, db), k, largest=False), 3),
               "bound_ms": b, "bound_by": by}
        log(f"  knn_topk {label}: {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms, cdist + topk (two calls) "
            f"{row['cdist_topk_ms']:.4f} ms, bound {b:.4f} ms ({by})")
        err = max(err, compare_knn_topk(q, db, k, label))
        rows.append(row)
        for key in tot:
            tot[key] += row[key]
    # the head's graph at stage 4, B=128 (not a 3p call): its least work
    # counts the x half only, the xs half drops out of the ranking
    q, _ = head_graph_input(128, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    b, by = knn_bound(128, q.shape[1], q.shape[1], 128, K + 1, True)
    label = f"head graph 128x{q.shape[1]} self, C=128+128, k={K + 1}"
    head = {"shape": label, "ms": time_ms(lambda: knn_topk(q, q, K + 1), 5),
            "plain_ms": time_ms(lambda: knn_topk_reference(q, q, K + 1), 2),
            "cdist_topk_ms": time_ms(lambda: torch.topk(
                torch.cdist(q, q), K + 1, largest=False), 3),
            "bound_ms": b, "bound_by": by}
    log(f"  knn_topk {label}: {head['ms']:.4f} ms, plain "
        f"{head['plain_ms']:.3f} ms, cdist + topk (two calls) "
        f"{head['cdist_topk_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    err = max(err, compare_knn_topk(q, q, K + 1, label))
    del q
    res = {"knn_topk": dict(tot, bound_by=max(rows, key=lambda r: r[
        "bound_ms"])["bound_by"], library_ms=None, max_abs_err=err,
        by_shape=rows, head_graph=head,
        shape="the three 3p calls together: " + "; ".join(
            r["shape"] for r in rows))}

    B, M, C = x128.shape
    b, by = knn_bound(B, M, M, C, K, True, gather=True)
    ms = time_ms(lambda: knn_gather(x128, K), 10)
    plain = time_ms(lambda: knn_gather_reference(x128, K), 2)

    def three_calls():
        idx = torch.topk(torch.cdist(x128, x128), K + 1,
                         largest=False).indices[..., 1:]
        return grouping(x128, idx)

    lib3 = time_ms(three_calls, 3)
    label = f"{PO_B}x{PO_ROWS} self, C=128, k={K}"
    log(f"  knn_gather {label}: {ms:.4f} ms, plain {plain:.3f} ms, cdist + "
        f"topk + grouping (three calls) {lib3:.4f} ms, bound {b:.4f} ms "
        f"({by})")
    res["knn_gather"] = {
        "ms": ms, "plain_ms": plain, "cdist_topk_ms": lib3, "bound_ms": b,
        "bound_by": by, "library_ms": None, "shape": label,
        "max_abs_err": compare_knn_gather(x128, K, label)}
    return res


# ------------------------------------------ the data-parallel slice: phase 3m
PAR_STEPS = 3            # train steps of the world-size-1 group and its twin
PAR_CLOUDS = 70          # generate() and the pairwise rows over two ranks
PAR_TILE = 32            # 3 row tiles of 70 clouds: 2 on rank 0, 1 on rank 1
PAR_TIMEOUT_S = 600      # the two ranks' deadline (and each collective's)
# a graph that differs from one process's at a near-tie: at each slot
# where a row differs, the two neighbours' squared distances within this
# relative gap
NEAR_TIE = 1e-4


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _Collectives:
    """Counts ``torch.distributed.all_reduce`` and ``broadcast`` calls and
    their bytes while active (the port calls them through the module)."""

    NAMES = ("all_reduce", "broadcast")

    def __enter__(self):
        import collections

        import torch.distributed as dist

        self.dist, self.saved = dist, {n: getattr(dist, n) for n in self.NAMES}
        self.calls, self.bytes = collections.Counter(), collections.Counter()
        for name, fn in self.saved.items():
            def counted(t, *args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += 1
                self.bytes[_name] += t.numel() * t.element_size()
                return _fn(t, *args, **kwargs)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _trainer_run(root: str, tag: str, mesh) -> dict:
    """``PDGNTrainer.train`` for PAR_STEPS steps at full width, B=35, then
    ``PDGNTrainer.test``, on ``mesh`` (None: no group): each step's six
    metrics, launches, collectives, step seconds and the test results."""
    import numpy as np
    import torch
    import pdgn_tpu_torch.train.trainer as trainer_mod
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    work = os.path.join(root, "pdgn_tpu_torch", "_build", f"smoke_m_{tag}")
    shutil.rmtree(work, ignore_errors=True)
    cfg = ExperimentConfig(batch_size=TRAIN_B, max_epoch=1,
                           max_steps_per_epoch=PAR_STEPS,
                           synthetic_size=TRAIN_B * PAR_STEPS,
                           checkpoint_dir=work, model_dir="smoke",
                           save_dir=work, device="cuda")
    trainer = PDGNTrainer(cfg, mesh)
    trainer.build_model(seed=SEED)
    metrics, step_fn = [], trainer_mod.train_step

    def recorded(*args, **kwargs):
        m = step_fn(*args, **kwargs)
        metrics.append(torch.stack(list(m.values())).cpu())
        return m

    np.random.seed(SEED)
    _lib.LAUNCHES.clear()
    trainer_mod.train_step = recorded
    try:
        with _Collectives() as col:
            trainer.train(seed=SEED)
    finally:
        trainer_mod.train_step = step_fn
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    _lib.LAUNCHES.clear()
    results = trainer.test(tile=TEST_TILE)
    torch.cuda.synchronize()
    test_launches = dict(_lib.LAUNCHES)
    shutil.rmtree(work, ignore_errors=True)
    return {"metrics": torch.stack(metrics), "launches": launches,
            "test_launches": test_launches, "results": results,
            "step_seconds": list(trainer.step_seconds),
            "calls": dict(col.calls), "bytes": dict(col.bytes)}


def _two_rank_inputs():
    """The global batch of phase 3m's two-rank step: 35 clouds per
    resolution from numpy, the D and G noise from a seeded card
    generator (CPU tensors, to hand to the ranks)."""
    import numpy as np
    import torch

    rs = np.random.RandomState(SEED)
    reals = [torch.from_numpy((rs.randn(TRAIN_B, 2048 >> s, 3) * 0.5)
                              .astype(np.float32)) for s in (3, 2, 1, 0)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = [0.2 * torch.randn(TRAIN_B, 128, generator=gen, device="cuda")
             for _ in range(2)]
    return reals, [z.cpu() for z in noise]


def _rank_work(mesh, reals, noise, device) -> dict:
    """What phase 3m compares between two ranks and one process: the
    generator's clouds, its graphs of both noises (and, for one process,
    the features they are built on), the pairwise rows and one train step
    (``mesh`` None: one process on the whole batch)."""
    import torch
    from pdgn_tpu_torch.eval.metrics import pairwise_cd_emd
    from pdgn_tpu_torch.ops.kernels import _lib
    from pdgn_tpu_torch.train.generate import generate
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer
    from pdgn_tpu_torch.train.train_step import train_step

    trainer = PDGNTrainer(ExperimentConfig(batch_size=TRAIN_B,
                                           device="cuda"), mesh)
    trainer.build_model(seed=SEED)
    G = trainer.state.generator
    clouds = generate(PAR_CLOUDS, TRAIN_B, SEED, device=device, model=G,
                      mesh=mesh)
    cd, emd = pairwise_cd_emd(clouds, clouds[::-1].copy(), tile=PAR_TILE,
                              mesh=mesh, device=device)
    rows = slice(0, TRAIN_B) if mesh is None else mesh.rows(TRAIN_B)
    noise = [z.to(device) for z in noise]
    G.eval()
    graphs = []
    with torch.no_grad(), _graph_inputs() as inputs:
        for z in noise:
            graphs.append([g.cpu() for g in G(z[rows], return_graphs=True,
                                              batch=TRAIN_B)[1]])
    G.train()
    _lib.LAUNCHES.clear()
    m = train_step(trainer.state, [r[rows].to(device) for r in reals],
                   *noise, trainer.tcfg)
    m = torch.stack(list(m.values())).cpu()
    torch.cuda.synchronize()
    return {"clouds": clouds, "cd": cd, "emd": emd, "metrics": m,
            "graphs": graphs,
            "graph_inputs": ([inputs[:4], inputs[4:]] if mesh is None
                             else None),
            "launches": dict(_lib.LAUNCHES)}


@contextlib.contextmanager
def _graph_inputs():
    """The features each stage head builds its kNN graph on (``[xs | x]``,
    as ``head_operands`` concatenates them), on the CPU, for the forwards
    run inside."""
    import torch
    import pdgn_tpu_torch.models.generator as generator

    found, head = [], generator.edge_conv_head

    def recorded(x, *args, xs=None, **kwargs):
        knn_in = x if xs is None else torch.cat(
            [xs[:, None, :].expand(*x.shape[:2], xs.shape[-1]), x], dim=-1)
        found.append(knn_in.float().cpu())
        return head(x, *args, xs=xs, **kwargs)

    generator.edge_conv_head = recorded
    try:
        yield found
    finally:
        generator.edge_conv_head = head


def near_tie(graphs, want, inputs, rows_max: int = 4096):
    """``(stage, rows, gap)`` at the first stage whose graph ``graphs``
    differs from ``want``: the rows that differ and, over them (at most
    ``rows_max``), the largest relative difference between the squared
    distances of the two graphs' neighbours at a slot where they differ, in
    float64 on ``want``'s own features ``inputs``: two neighbours swapped in
    order, or one traded for another at the set's edge, differ by a
    near-tie's gap. None when every stage agrees."""
    import torch

    for stage, (a, b) in enumerate(zip(graphs, want)):
        differ = (a != b).any(dim=-1)
        if differ.any():
            break
    else:
        return None
    bi, ni = differ.nonzero(as_tuple=True)
    bi, ni = bi[:rows_max], ni[:rows_max]
    x = inputs[stage].double()
    q = x[bi, ni][:, None, :]

    def sqdist(idx):
        return ((x[bi[:, None], idx[bi, ni]] - q) ** 2).sum(-1)

    da, db = sqdist(a), sqdist(b)
    slots = a[bi, ni] != b[bi, ni]
    gap = ((da - db).abs() / db)[slots].max()
    return stage + 1, int(differ.sum()), float(gap)


def _rank_main(rank: int, world: int, port: int, out_dir: str, reals,
               noise) -> None:
    """One of phase 3m's two ranks on the one card (gloo: NCCL takes one
    rank a card)."""
    import torch
    import torch.distributed as dist
    from pdgn_tpu_torch.parallel import initialize_distributed, make_mesh
    from pdgn_tpu_torch.utils.misc import resolve_device

    initialize_distributed(f"localhost:{port}", world, rank, device="cuda",
                           backend="gloo", timeout_s=PAR_TIMEOUT_S)
    try:
        mesh = make_mesh("cuda:0")
        out = _rank_work(mesh, reals, noise, resolve_device(mesh.device))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn_two(out_dir: str, reals, noise) -> list:
    """Run :func:`_rank_main` on two processes; kill both and fail past
    PAR_TIMEOUT_S."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.spawn(_rank_main, args=(2, _free_port(), out_dir, reals, noise),
                   nprocs=2, join=False)
    deadline = time.perf_counter() + PAR_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            require(time.perf_counter() < deadline,
                    f"the two ranks did not end in {PAR_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]


def parallel_path(root: str, smi: str, dev) -> dict:
    """Phase 3m: the data-parallel path. (1) an NCCL group of one rank
    drives ``PDGNTrainer.train`` (3 steps, full width, B=35) and the test
    phase, and must give the no-group run's bits and launches; (2) two
    ranks on the one card (gloo) must give one process's ``generate()``
    clouds and pairwise rows exactly and its first step's metrics within
    rel 1e-3, g_loss's larger gap traced to a kNN near-tie of either
    generator forward; (3) the collectives a step and the step times with
    and without the group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from pdgn_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                         shard_rows)
    from pdgn_tpu_torch.train.train_step import METRICS

    alone = _trainer_run(root, "alone", None)
    initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        require(dist.get_backend() == "nccl", "the card's group is not NCCL")
        group = _trainer_run(root, "group", make_mesh("cuda:0"))
    finally:
        dist.destroy_process_group()
    require(torch.equal(group["metrics"], alone["metrics"]),
            f"the group's step metrics differ from the no-group run's: "
            f"{group['metrics']} != {alone['metrics']}")
    require(group["results"] == alone["results"],
            f"test results {group['results']} != {alone['results']}")
    want = {k: v * PAR_STEPS for k, v in PER_STEP.items()}
    for run in (alone, group):
        require(run["launches"] == want,
                f"launches {run['launches']} != {want}")
    require(group["test_launches"] == alone["test_launches"],
            f"test launches {group['test_launches']} != "
            f"{alone['test_launches']}")
    require(not alone["calls"], f"collectives without a group: "
            f"{alone['calls']}")
    per_step = {k: v / PAR_STEPS for k, v in group["calls"].items()}
    bytes_step = {k: v / PAR_STEPS for k, v in group["bytes"].items()}
    step_s = {"group": group["step_seconds"], "alone": alone["step_seconds"]}
    line = {"card": smi, "collectives_per_step": per_step,
            "collective_bytes_per_step": bytes_step,
            "step_seconds_w1_group": step_s["group"],
            "step_seconds_no_group": step_s["alone"]}
    log(f"  W=1 NCCL group: {PAR_STEPS} steps and the test phase equal the "
        f"no-group run bit for bit; launches {group['launches']}")
    print(json.dumps(line), flush=True)

    reals, noise = _two_rank_inputs()
    out_dir = os.path.join(root, "pdgn_tpu_torch", "_build", "smoke_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    try:
        ranks = _spawn_two(out_dir, reals, noise)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    two_s = time.perf_counter() - t0
    one = _rank_work(None, reals, noise, dev)
    for r, out in enumerate(ranks):
        require(out["launches"] == PER_STEP,
                f"rank {r} launches {out['launches']} != {PER_STEP}")
        require(np.array_equal(out["clouds"], one["clouds"]),
                f"rank {r}: generate() clouds differ from one process's")
        require(np.array_equal(out["cd"], one["cd"])
                and np.array_equal(out["emd"], one["emd"]),
                f"rank {r}: pairwise rows differ from one process's")
    require(torch.equal(ranks[0]["metrics"], ranks[1]["metrics"]),
            "the two ranks' metrics differ")
    gaps = dict(zip(METRICS, ((ranks[0]["metrics"] - one["metrics"]).abs()
                              / one["metrics"].abs()).tolist()))
    gap = max(gaps.values())
    flips, ties = [], []
    for f in range(2):                  # the D noise, the G noise
        two_graphs = [torch.cat([a, b]) for a, b in
                      zip(ranks[0]["graphs"][f], ranks[1]["graphs"][f])]
        flips.append(sum(int((a != c).sum()) for a, c in
                         zip(two_graphs, one["graphs"][f])))
        ties.append(near_tie(two_graphs, one["graphs"][f],
                             one["graph_inputs"][f]))
    shards = [len(range(TRAIN_B)[shard_rows(TRAIN_B, r, 2)]) for r in (0, 1)]
    log(f"  two ranks ({shards[0]} + {shards[1]} rows, gloo, one card): "
        f"generate() and "
        f"{PAR_CLOUDS}x{PAR_CLOUDS} pairwise rows equal one process's; "
        f"first-step metrics rel gaps "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; graph entries that differ from one process's (D noise, G "
        f"noise): {flips}; first differing stage, rows and the largest "
        f"distance gap of a differing slot: {ties}; {two_s:.1f} s")
    held = {k: v for k, v in gaps.items() if k != "g_loss"}
    require(max(held.values()) <= 1e-3,
            f"two-rank metrics off one process's beyond rel 1e-3: {held}")
    tied = any(t is not None and t[2] <= NEAR_TIE for t in ties)
    require(gaps["g_loss"] <= 1e-3 or tied,
            f"two-rank g_loss {gaps['g_loss']:.3e} off one process's, "
            f"graphs {ties}")
    return {"launches": {k: group["launches"].get(k, 0)
                         + group["test_launches"].get(k, 0)
                         for k in set(group["launches"])
                         | set(group["test_launches"])},
            "w1": line, "two_rank_metric_gap": gap,
            "two_rank_metric_gaps": gaps, "two_rank_flips": flips,
            "two_rank_near_ties": ties,
            "two_rank_metrics": ranks[0]["metrics"].tolist(),
            "one_metrics": one["metrics"].tolist(), "two_rank_s": two_s}


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
    "emd_cd": ("pdgn_tpu_torch/csrc/emd_cd.cu",
               "pdgn_tpu/ops/pallas/emd_cd.py:52"),
    "knn_topk": ("pdgn_tpu_torch/csrc/knn.cu",
                 "pdgn_tpu/ops/pallas/knn.py:32"),
    "knn_gather": ("pdgn_tpu_torch/csrc/knn.cu",
                   "pdgn_tpu/ops/pallas/knn.py:119"),
    "edge_head_bf16": ("pdgn_tpu_torch/csrc/edge_head.cu",
                       "pdgn_tpu/ops/pallas/edge_head.py:74"),
    "slot_stats_bf16": ("pdgn_tpu_torch/csrc/slot_stats.cu",
                        "pdgn_tpu/ops/pallas/slot_stats.py:43"),
    "bilateral_tail_gated_bf16": ("pdgn_tpu_torch/csrc/bilateral_tail.cu",
                                  "pdgn_tpu/ops/pallas/bilateral_tail.py:74"),
    "bilateral_tail_plain_bf16": ("pdgn_tpu_torch/csrc/bilateral_tail.cu",
                                  "pdgn_tpu/ops/pallas/bilateral_tail.py:117"),
    "edge_head_bwd_bf16": ("pdgn_tpu_torch/csrc/edge_head_bwd.cu",
                           "pdgn_tpu/ops/pallas/edge_head.py:200"),
    "bilateral_tail_gated_bwd_bf16": (
        "pdgn_tpu_torch/csrc/bilateral_tail_bwd.cu",
        "pdgn_tpu/ops/pallas/bilateral_tail.py:135"),
    "bilateral_tail_plain_bwd_bf16": (
        "pdgn_tpu_torch/csrc/bilateral_tail_bwd.cu",
        "pdgn_tpu/ops/pallas/bilateral_tail.py:240"),
}


T0 = time.perf_counter()


def phase(msg: str) -> None:
    """Log a phase's start with the seconds since the script started."""
    log(f"[{time.perf_counter() - T0:.1f} s] {msg}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full results to this JSON file")
    ap.add_argument("--parallel-alone", action="store_true",
                    help="build the kernels and run phase 3m alone")
    ap.add_argument("--train-alone", action="store_true",
                    help="build the kernels, run phase 3t alone and print "
                    "its steps/s; copied into another checkout's root, it "
                    "times that checkout's trainer")
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
    if args.parallel_alone:
        par = parallel_path(root, smi, dev)
        par.pop("launches")
        print(json.dumps({"card": smi, "parallel": par}))
        return 0
    if args.train_alone:
        ckpt_root = os.path.join(root, "pdgn_tpu_torch", "_build",
                                 "smoke_train_alone")
        try:
            train = train_path(ckpt_root)
        finally:
            shutil.rmtree(ckpt_root, ignore_errors=True)
        print(json.dumps({"card": smi,
                          "train_steps_per_s_b35": train["steps_per_s"],
                          "train_steps_per_s_period":
                              train["steps_per_s_period"]}))
        return 0

    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase("phase 2: kernels against their plain versions (B=8)")
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

    from pdgn_tpu_torch.ops.kernels.edge_head import HEAD_BITS, head_bits
    bits = head_bits(dev)
    log(f"  head forward digest {bits}")
    require(bits == HEAD_BITS, "the head forward's bits moved")
    core = check_core(gen, dev)
    phase("phase 2n: knn_topk, emd_cd and FPS on the card against the "
          "native CPU oracles")
    oracles = native_oracles(dev, smi)

    phase("phase 2t: train kernels against their plain versions (B=8)")
    errs.update(check_train_kernels(gen, dev))
    from compare_head_bits import BWD_BITS, _kernels, bwd_digest
    bwd_bits = bwd_digest(_kernels(), dev)
    log(f"  fp32 backward digest {bwd_bits}")
    require(bwd_bits == BWD_BITS, "the fp32 backward kernels' bits moved")
    phase(f"phase 2e: emd_cd against its plain version (n={EMD_N})")
    errs["emd_cd"] = check_emd_cd(dev)
    phase("phase 2p: knn_topk and knn_gather against their plain versions "
        "(B=8)")
    errs.update(check_knn_kernels(gen, dev))
    phase("phase 2w: the widened shapes against their plain versions, timed "
        "once")
    wide = check_wide_shapes(gen, dev)
    phase("phase 2b: the bf16 instances against their bf16 plain versions")
    errs.update(check_bf16_kernels(gen, dev))
    phase("phase 2bt: the bf16 backward instances against their bf16 plain "
        "versions")
    bt_errs, bt_kinks = check_bf16_train_kernels(gen, dev)
    errs.update(bt_errs)

    phase("phase 3: main path, generate() at full width")
    path = main_path(dev)
    model = path.pop("model")
    phase("phase 3b: main path in bf16, generate() at full width, "
        "--compute_dtype bfloat16")
    path_bf16 = main_path_bf16(dev, model)

    ckpt_root = os.path.join(root, "pdgn_tpu_torch", "_build", "smoke_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        phase(f"phase 3t: train path, PDGNTrainer.train at full width, "
            f"B={TRAIN_B}")
        train = train_path(ckpt_root)
        phase(f"phase 3e: test path, PDGNTrainer.test(tile={TEST_TILE}) at "
            f"full width on {TEST_CLOUDS} clouds, 3t's bundles")
        test = test_path(root, ckpt_root, dev)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    phase(f"phase 3be: test path in bf16, PDGNTrainer.test(tile={TEST_TILE}) "
        f"with compute_dtype bfloat16 on {TEST_CLOUDS} clouds")
    test_bf16 = test_path_bf16(root, dev)
    phase(f"phase 3bt: train path in bf16, PDGNTrainer.train at full width, "
        f"B={TRAIN_B}, --compute_dtype bfloat16")
    train_bf16 = train_path_bf16(root, smi)
    train_bf16["kinks_2bt"] = bt_kinks
    phase("phase 3d: data path, the hdf5 reader, the pinned loader and the "
        "CLI's shapenet15k train, msgpack resume and test at full width")
    data = data_path(root, smi, dev)
    phase(f"phase 3p: point-ops path, pdgn_tpu_torch.ops at full width on "
        f"{PO_B} generated clouds")
    point_ops = point_ops_path(model, gen, dev)
    del model
    phase("phase 3m: data-parallel path, an NCCL group of one rank through "
          "PDGNTrainer.train and test, two ranks on the card over gloo")
    par = parallel_path(root, smi, dev)
    po_inputs = point_ops.pop("inputs")
    for name, e in point_ops.pop("max_abs_err").items():
        errs[name] = max(errs[name], e)

    phase("phase 4: kernel times and checks at the main path's B=128 shapes")
    times = time_kernels(dev, gen)
    phase(f"phase 4t: train kernel times and checks at B={TRAIN_B}")
    times.update(time_train_kernels(dev, gen))
    phase(f"phase 4e: emd_cd times at the test path's {TEST_TILE}x{TEST_TILE} "
        f"tile")
    times["emd_cd"] = time_emd_cd(dev)
    phase("phase 4p: knn_topk and knn_gather times at the point-ops path's "
        "shapes")
    times.update(time_knn(po_inputs, dev))
    del po_inputs
    phase("phase 4b: bf16 instance times and checks at the main path's B=128 "
        "shapes")
    times.update(time_bf16_kernels(dev, gen))
    phase(f"phase 4bt: bf16 backward instance times and checks at "
        f"B={TRAIN_B}")
    times.update(time_bf16_train_kernels(dev, gen))

    phase("the kernels line")
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = times[name]
        by_path = {"sample": path["launches"].get(name, 0),
                   "train": train["launches"].get(name, 0),
                   "test": test["launches"].get(name, 0),
                   "data": data["launches"].get(name, 0),
                   "point_ops": point_ops["launches"].get(name, 0),
                   "sample_bf16": path_bf16["launches"].get(name, 0),
                   "test_bf16": test_bf16["launches"].get(name, 0),
                   "train_bf16": train_bf16["launches"].get(name, 0),
                   "parallel": par["launches"].get(name, 0)}
        require(sum(by_path.values()) > 0, f"{name} never launched")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        for extra in ("cdist_topk_ms", "sub_yardstick", "largest_call",
                      "kink_share"):
            if extra in t:
                kernels[-1][extra] = t[extra]
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
                       "core": core,
                       "wide": wide,
                       "train": train, "test": test, "data": data,
                       "point_ops": point_ops, "path_bf16": path_bf16,
                       "test_bf16": test_bf16, "train_bf16": train_bf16,
                       "parallel": par, "bwd_bits": bwd_bits,
                       "native_oracles": oracles}, f, indent=1)
    print(json.dumps({"card": smi,
                      "clouds_per_s_b128": path["clouds_per_s"],
                      "train_steps_per_s_b35": train["steps_per_s"],
                      "train_steps_per_s_period":
                          train["steps_per_s_period"],
                      "test_phase_s_64": test["seconds"],
                      "cd_emd_pairs_per_s": test["pairs_per_s"],
                      "chair_eval_min_estimate": test["chair_eval_min"],
                      "loader_batches_per_s_b35":
                          data["loader"]["batches_per_s"],
                      "data_wait_share": data["wait_share"],
                      "point_ops_path_s": point_ops["seconds"],
                      "bf16_clouds_per_s_b128": path_bf16["clouds_per_s"],
                      "bf16_test_phase_s_64": test_bf16["seconds"],
                      "bf16_chamfer_share": path_bf16["chamfer_share"],
                      "bf16_train_steps_per_s_b35":
                          train_bf16["steps_per_s"],
                      "w1_collectives_per_step":
                          par["w1"]["collectives_per_step"],
                      "two_rank_metric_gap": par["two_rank_metric_gap"],
                      "smoke_s": time.perf_counter() - T0}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
