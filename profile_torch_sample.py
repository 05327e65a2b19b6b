#!/usr/bin/env python3
"""Device-time breakdown of the port's sampling path.

Profiles ``--reps`` generator forwards of ``pdgn_tpu_torch`` at full width
(random weights from ``--seed``) with ``torch.profiler`` and prints, per
CUDA kernel name, its device time per forward and share, plus the
forward's wall time and the share of it in which the device ran no kernel
(negative if the kernel events overlap or are counted twice). Needs a
CUDA card; run from the root of the repository::

    python3 profile_torch_sample.py --batch 128 --out breakdown.json
"""

from __future__ import annotations

import argparse
import json
import os
import time


def profile(batch: int, reps: int, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from pdgn_tpu_torch.train.generate import build_generator
    from pdgn_tpu_torch.train.sampler import make_sampler
    from pdgn_tpu_torch.utils.misc import resolve_device

    dev = resolve_device("cuda")
    model = build_generator(seed, dev)
    sample = make_sampler(model)
    rng = torch.Generator(device=dev).manual_seed(seed)
    sample(batch, rng)                       # build + warm up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            sample(batch, rng)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
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
            "reps": reps, "wall_ms_per_forward": wall_ms,
            "device_busy_ms_per_forward": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": [{"name": n, "ms_per_forward": ms,
                         "share": ms / busy_ms if busy_ms else 0.0,
                         "calls_per_forward": c} for n, ms, c in rows]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile(args.batch, args.reps, args.seed)
    print(f"{res['card']}: B={res['batch']}, wall "
          f"{res['wall_ms_per_forward']:.3f} ms/forward, device busy "
          f"{res['device_busy_ms_per_forward']:.3f} ms, idle share "
          f"{res['idle_share']:.3f}")
    for k in res["kernels"][:25]:
        print(f"{k['ms_per_forward']:10.3f} ms {100 * k['share']:6.2f}% "
              f"x{k['calls_per_forward']:<4d} {k['name'][:110]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
