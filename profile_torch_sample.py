#!/usr/bin/env python3
"""Device-time breakdown of the port's sampling path, its train step, or
its test phase.

Profiles ``--reps`` iterations of ``pdgn_tpu_torch`` at full width (random
weights from ``--seed``) with ``torch.profiler``: generator forwards of the
sampler, with ``--train`` GAN train steps (``train_step`` on random real
clouds), or with ``--test`` whole test phases (``PDGNTrainer.test(tile=64)``
on ``--clouds`` synthetic clouds, sampled in batches of ``--batch``), after
one warm-up iteration. Prints, per CUDA kernel name, its device time per
iteration and share, plus the iteration's wall time and the share of it in
which the device ran no kernel (negative if the kernel events overlap or are
counted twice). With ``--wall`` it runs no profiler and prints each
iteration's wall time (synchronised) and iterations per second instead:
iterations/s of two checkouts compared in one call (this script copied into
the other checkout's root imports that checkout's package). Needs a CUDA
card; run from the root of the repository::

    python3 profile_torch_sample.py --batch 128 --out breakdown.json
    python3 profile_torch_sample.py --train --batch 35
    python3 profile_torch_sample.py --train --batch 35 --reps 30 --wall
    python3 profile_torch_sample.py --test --batch 35 --clouds 64 --reps 2
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def sample_iteration(batch: int, seed: int, dev):
    """One sampler forward of a seeded full-width generator."""
    import torch

    from pdgn_tpu_torch.train.generate import build_generator
    from pdgn_tpu_torch.train.sampler import make_sampler

    sample = make_sampler(build_generator(seed, dev))
    rng = torch.Generator(device=dev).manual_seed(seed)
    return lambda: sample(batch, rng)


def train_iteration(batch: int, seed: int, dev):
    """One GAN train step at full width on fixed random real clouds."""
    import torch

    from pdgn_tpu_torch.train.train_step import train_step
    from pdgn_tpu_torch.train.trainer import ExperimentConfig, PDGNTrainer

    trainer = PDGNTrainer(ExperimentConfig(batch_size=batch,
                                           device=dev.type))
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


def profile(batch: int, reps: int, seed: int, train: bool = False,
            test: bool = False, clouds: int = 64, wall: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from pdgn_tpu_torch.utils.misc import resolve_device

    dev = resolve_device("cuda")
    out_dir = tempfile.TemporaryDirectory()
    if test:
        iteration = test_iteration(batch, seed, dev, clouds, out_dir.name)
    else:
        iteration = (train_iteration if train else sample_iteration)(
            batch, seed, dev)
    iteration()                              # build + warm up
    torch.cuda.synchronize()
    kind = "test phase" if test else "train step" if train else "forward"
    if wall:
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
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            iteration()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    out_dir.cleanup()
    rows = []
    for ev in prof.key_averages():
        # device-side kernel events only (the aten ops that launched them
        # carry the same time again)
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((ev.key, dev_us / reps / 1e3, ev.count // reps))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    wall_ms = wall_s / reps * 1e3
    return {"card": torch.cuda.get_device_name(0), "batch": batch,
            "iteration": kind,
            "reps": reps, "wall_ms_per_iteration": wall_ms,
            "device_busy_ms_per_iteration": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": [{"name": n, "ms_per_iteration": ms,
                         "share": ms / busy_ms if busy_ms else 0.0,
                         "calls_per_iteration": c} for n, ms, c in rows]}


def print_breakdown(res: dict) -> None:
    print(f"{res['card']}: B={res['batch']}, wall "
          f"{res['wall_ms_per_iteration']:.3f} ms per {res['iteration']}, "
          f"device busy {res['device_busy_ms_per_iteration']:.3f} ms, idle "
          f"share {res['idle_share']:.3f}")
    for k in res["kernels"][:30]:
        print(f"{k['ms_per_iteration']:10.3f} ms {100 * k['share']:6.2f}% "
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile(args.batch, args.reps, args.seed, args.train, args.test,
                  args.clouds, args.wall)
    if args.wall:
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
