#!/usr/bin/env python3
"""Device-time breakdown of the port's sampling path, its train step, its
test phase, or the backward of its local statistics.

Profiles ``--reps`` iterations of ``pdgn_tpu_torch`` at full width (random
weights from ``--seed``) with ``torch.profiler``: generator forwards of the
sampler, with ``--train`` GAN train steps (``train_step`` on random real
clouds), or with ``--test`` whole test phases (``PDGNTrainer.test(tile=64)``
on ``--clouds`` synthetic clouds, sampled in batches of ``--batch``), or
with ``--local-stats`` the backward of each of the shape loss's 9
``local_mean_cov`` calls of a train step alone (``torch.autograd.grad``
through the public entry, so any checkout's kernels), after one warm-up
iteration. ``--compute_dtype bfloat16`` builds the generator in bf16: the
sampler's (the bf16 instances of the forward kernels) or, with
``--train``, the trainer's (``compute_dtype="bfloat16"``: the bf16
instances forward and backward, fp32 discriminators). ``--group`` makes
the train step's trainer the one rank of an NCCL group
(``pdgn_tpu_torch.parallel``: global batch statistics and summed gradients
through ``all_reduce``, which a group of one leaves as they are). Prints,
per CUDA
kernel
name, its device time per
iteration and share, plus the iteration's wall time and the share of it in
which the device ran no kernel (negative if the kernel events overlap or are
counted twice), and the host operators with the most time of their own. With ``--wall`` it runs no profiler and prints each
iteration's wall time (synchronised) and iterations per second instead:
iterations/s of two checkouts compared in one call (this script copied into
the other checkout's root imports that checkout's package). Needs a CUDA
card; run from the root of the repository::

    python3 profile_torch_sample.py --batch 128 --out breakdown.json
    python3 profile_torch_sample.py --batch 128 --compute_dtype bfloat16
    python3 profile_torch_sample.py --train --batch 35
    python3 profile_torch_sample.py --train --batch 35 --compute_dtype bfloat16
    python3 profile_torch_sample.py --train --batch 35 --reps 30 --wall
    python3 profile_torch_sample.py --train --batch 35 --reps 5 --group
    python3 profile_torch_sample.py --test --batch 35 --clouds 64 --reps 2
    python3 profile_torch_sample.py --local-stats --batch 35 --reps 20
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def sample_iteration(batch: int, seed: int, dev, dtype=None):
    """One sampler forward of a seeded full-width generator (in ``dtype``:
    None for fp32, or ``torch.bfloat16``)."""
    import torch

    from pdgn_tpu_torch.train.generate import build_generator
    from pdgn_tpu_torch.train.sampler import make_sampler

    sample = make_sampler(build_generator(seed, dev, dtype=dtype))
    rng = torch.Generator(device=dev).manual_seed(seed)
    return lambda: sample(batch, rng)


def train_iteration(batch: int, seed: int, dev, compute_dtype=None,
                    group: bool = False):
    """One GAN train step at full width on fixed random real clouds
    (``compute_dtype``: the trainer's, None for fp32 or "bfloat16"; with
    ``group``, as the one rank of an NCCL group)."""
    import torch

    from pdgn_tpu_torch.train.train_step import train_step
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    mesh = None
    if group:
        import socket

        from pdgn_tpu_torch.parallel import initialize_distributed, make_mesh

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        initialize_distributed(f"localhost:{port}", 1, 0, device="cuda")
        mesh = make_mesh(dev)
    trainer = PDGNTrainer(ExperimentConfig(batch_size=batch,
                                           device=dev.type,
                                           compute_dtype=compute_dtype),
                          mesh)
    trainer.build_model(seed)
    rng = torch.Generator(device=dev).manual_seed(seed)
    reals = [torch.randn(batch, n, 3, generator=rng, device=dev)
             for n in trainer.sizes]
    cfg = trainer.tcfg

    def step():
        noise = [cfg.noise_sigma * torch.randn(batch, cfg.noise_dim,
                                               generator=rng, device=dev)
                 for _ in range(2)]
        return train_step(trainer.state, reals, *noise, cfg)

    return step


def test_iteration(batch: int, seed: int, dev, clouds: int, out_dir: str):
    """One test phase at full width: ``clouds`` generated clouds scored
    against as many synthetic ones in 64x64 tiles; dumps go to
    ``out_dir``."""
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    trainer = PDGNTrainer(ExperimentConfig(batch_size=batch,
                                           synthetic_size=clouds,
                                           save_dir=out_dir,
                                           device=dev.type))
    trainer.build_model(seed)
    return lambda: trainer.test(tile=64)


def local_stats_bwd_iterations(batch: int, seed: int, dev):
    """``(label, iteration)`` for each of the shape loss's 9 calls
    (``chip_smoke.SHAPE_LOSS_CALLS`` on ``chip_smoke.shape_loss_clouds``):
    the backward of one ``local_mean_cov`` call (k=20) with random
    cotangents."""
    import torch

    from chip_smoke import SHAPE_LOSS_CALLS, shape_loss_clouds
    from pdgn_tpu_torch.ops.kernels.local_stats import local_mean_cov

    rng = torch.Generator(device=dev).manual_seed(seed)
    clouds = shape_loss_clouds(batch, rng, dev)
    out = []
    for m, n in SHAPE_LOSS_CALLS:
        src = clouds[n].clone().requires_grad_(True)
        mu, cov = local_mean_cov(src, clouds[m], 20)
        cts = (torch.randn(mu.shape, generator=rng, device=dev),
               torch.randn(cov.shape, generator=rng, device=dev))
        out.append((f"M={m} N={n}", lambda mu=mu, cov=cov, src=src, cts=cts:
                    torch.autograd.grad((mu, cov), (src,), cts,
                                        retain_graph=True)))
    return out


def profile_local_stats(batch: int, reps: int, seed: int) -> dict:
    """The device time of each of the 9 backwards, profiled one by one, and
    their sum."""
    from pdgn_tpu_torch.utils.misc import resolve_device

    dev = resolve_device("cuda")
    calls = []
    for label, iteration in local_stats_bwd_iterations(batch, seed, dev):
        res = profile_iteration(iteration, batch, reps, f"backward {label}")
        calls.append(dict(res, call=label))
    return {"card": calls[0]["card"], "batch": batch,
            "iteration": "local_mean_cov backward", "reps": reps,
            "device_ms_sum": sum(c["device_busy_ms_per_iteration"]
                                 for c in calls), "calls": calls}


def profile(batch: int, reps: int, seed: int, train: bool = False,
            test: bool = False, clouds: int = 64, wall: bool = False,
            bf16: bool = False, group: bool = False) -> dict:
    import torch

    from pdgn_tpu_torch.utils.misc import resolve_device

    dev = resolve_device("cuda")
    out_dir = tempfile.TemporaryDirectory()
    if test:
        iteration = test_iteration(batch, seed, dev, clouds, out_dir.name)
    elif train:
        iteration = train_iteration(batch, seed, dev,
                                    "bfloat16" if bf16 else None, group)
    else:
        iteration = sample_iteration(batch, seed, dev,
                                     torch.bfloat16 if bf16 else None)
    kind = "test phase" if test else "train step" if train else "forward"
    if wall:
        iteration()                          # build + warm up
        torch.cuda.synchronize()
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            iteration()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out_dir.cleanup()
        return {"card": torch.cuda.get_device_name(0), "batch": batch,
                "iteration": kind, "reps": reps,
                "iteration_seconds": seconds,
                "iterations_per_s": reps / sum(seconds)}
    res = profile_iteration(iteration, batch, reps, kind)
    out_dir.cleanup()
    return res


def profile_iteration(iteration, batch: int, reps: int, kind: str) -> dict:
    """``reps`` calls of ``iteration`` under ``torch.profiler`` after one
    warm-up call: device time per CUDA kernel name, wall time, idle share."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    iteration()                              # build + warm up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            iteration()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows, host = [], []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            host.append((ev.key, ev.self_cpu_time_total / reps / 1e3,
                         ev.count // reps))
        # device-side kernel events only (the aten ops that launched them
        # carry the same time again)
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((ev.key, dev_us / reps / 1e3, ev.count // reps))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    wall_ms = wall_s / reps * 1e3
    return {"card": torch.cuda.get_device_name(0), "batch": batch,
            "iteration": kind,
            "reps": reps, "wall_ms_per_iteration": wall_ms,
            "device_busy_ms_per_iteration": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": [{"name": n, "ms_per_iteration": ms,
                         "share": ms / busy_ms if busy_ms else 0.0,
                         "calls_per_iteration": c} for n, ms, c in rows],
            "host_ops": [{"name": n, "self_ms_per_iteration": ms,
                          "calls_per_iteration": c}
                         for n, ms, c in host[:20]]}


def print_breakdown(res: dict) -> None:
    print(f"{res['card']}: B={res['batch']}, wall "
          f"{res['wall_ms_per_iteration']:.3f} ms per {res['iteration']}, "
          f"device busy {res['device_busy_ms_per_iteration']:.3f} ms, idle "
          f"share {res['idle_share']:.3f}")
    for k in res["kernels"][:30]:
        print(f"{k['ms_per_iteration']:10.4f} ms {100 * k['share']:6.2f}% "
              f"x{k['calls_per_iteration']:<4d} {k['name'][:110]}")
    print("host operators, self time:")
    for k in res.get("host_ops", [])[:15]:
        print(f"{k['self_ms_per_iteration']:10.4f} ms "
              f"x{k['calls_per_iteration']:<4d} {k['name'][:110]}")



def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of sampler forwards")
    ap.add_argument("--test", action="store_true",
                    help="profile whole test phases (sampling + metrics)")
    ap.add_argument("--clouds", type=int, default=64,
                    help="test-set size of --test")
    ap.add_argument("--wall", action="store_true",
                    help="no profiler: each iteration's wall time only")
    ap.add_argument("--local-stats", action="store_true",
                    help="profile the backward of each of the shape loss's "
                         "9 local_mean_cov calls alone")
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the generator's dtype (the sampler's, or "
                         "with --train the trainer's)")
    ap.add_argument("--group", action="store_true",
                    help="with --train: the trainer as the one rank of an "
                         "NCCL group")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.group and not args.train:
        ap.error("--group profiles train steps only")
    bf16 = args.compute_dtype == "bfloat16"
    if bf16 and (args.test or args.local_stats):
        ap.error("--compute_dtype bfloat16 profiles sampler forwards and "
                 "train steps only")
    if args.local_stats:
        res = profile_local_stats(args.batch, args.reps, args.seed)
    else:
        res = profile(args.batch, args.reps, args.seed, args.train,
                      args.test, args.clouds, args.wall, bf16, args.group)
    if args.local_stats:
        for call in res["calls"]:
            print_breakdown(call)
        print(f"{res['card']}: B={res['batch']}, the 9 backwards' device "
              f"time summed {res['device_ms_sum']:.4f} ms")
    elif args.wall:
        secs = sorted(res["iteration_seconds"])
        print(f"{res['card']}: B={res['batch']}, {res['reps']} "
              f"{res['iteration']}s: {res['iterations_per_s']:.4f} per s, "
              f"median {secs[len(secs) // 2]:.4f} s, min {secs[0]:.4f} s, "
              f"max {secs[-1]:.4f} s")
    else:
        print_breakdown(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
