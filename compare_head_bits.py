#!/usr/bin/env python3
"""The head forward's bit digest from this checkout's kernels and from
another checkout's, in one process on the same card; with
``--local-stats``, the bits of ``local_mean_cov``'s outputs and gradient.

``pdgn_tpu_torch.ops.kernels.edge_head.head_bits`` draws the head's
operands with numpy and hashes the head's outputs. This script takes that
recipe from this checkout and runs it on this checkout's ``edge_head``; then
it unloads the package, imports the one under ``--against`` (an earlier
commit unpacked with ``git archive``, say), which builds its own kernels
into its own build directory, and runs the same recipe on that checkout's
``edge_head``. Prints both digests beside ``HEAD_BITS``; exits 1 unless all
three are equal. With ``--local-stats`` the recipe is this script's own
(``local_stats_outputs``: seeded clouds at the shape loss's 9 calls, mu,
cov and d_src through each checkout's public ``local_mean_cov`` and
autograd); it prints, per call, whether the two checkouts' outputs are
equal bit for bit, and exits 1 unless all are. Needs a CUDA card; run from
anywhere::

    python3 compare_head_bits.py --against /path/to/other/checkout
    python3 compare_head_bits.py --against /path/to/other --local-stats
"""

from __future__ import annotations

import argparse
import os
import sys


def local_stats_outputs(local_mean_cov, dev, B: int = 8) -> list:
    """mu, cov and d_src of ``local_mean_cov`` (k=20) at each of the shape
    loss's 9 calls (``chip_smoke.SHAPE_LOSS_CALLS`` on
    ``chip_smoke.shape_loss_clouds``), clouds and cotangents from one seed."""
    import torch

    from chip_smoke import SHAPE_LOSS_CALLS, shape_loss_clouds

    gen = torch.Generator(device=dev).manual_seed(2024)
    clouds = shape_loss_clouds(B, gen, dev)
    out = []
    for m, n in SHAPE_LOSS_CALLS:
        src = clouds[n].clone().requires_grad_(True)
        mu, cov = local_mean_cov(src, clouds[m], 20)
        cts = (torch.randn(B, m, 3, generator=gen, device=dev),
               torch.randn(B, m, 9, generator=gen, device=dev))
        (d_src,) = torch.autograd.grad((mu, cov), (src,), cts)
        out.append(((m, n), (mu.detach(), cov.detach(), d_src)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout (holds pdgn_tpu_torch/)")
    ap.add_argument("--local-stats", action="store_true",
                    help="compare local_mean_cov's outputs and gradient "
                         "instead of the head's digest")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_head_bits: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    other_root = os.path.abspath(args.against)
    sys.path.insert(0, root)
    from pdgn_tpu_torch.ops.kernels.edge_head import HEAD_BITS, head_bits
    from pdgn_tpu_torch.utils.misc import resolve_device

    dev = resolve_device("cuda")
    if args.local_stats:
        from pdgn_tpu_torch.ops.kernels.local_stats import local_mean_cov
        ours = local_stats_outputs(local_mean_cov, dev)
    else:
        ours = head_bits(dev)
    for name in [m for m in sys.modules
                 if m == "pdgn_tpu_torch" or m.startswith("pdgn_tpu_torch.")]:
        del sys.modules[name]
    sys.path[0] = other_root
    from pdgn_tpu_torch.ops.kernels import edge_head as other

    if not os.path.abspath(other.__file__).startswith(other_root + os.sep):
        print(f"compare_head_bits: imported {other.__file__}, not from "
              f"{other_root}", file=sys.stderr)
        return 1
    if args.local_stats:
        from pdgn_tpu_torch.ops.kernels.local_stats import local_mean_cov
        theirs = local_stats_outputs(local_mean_cov, dev)
        same = True
        for ((m, n), a), (_, b) in zip(ours, theirs):
            eq = [bool((x == y).all()) for x, y in zip(a, b)]
            gap = float((a[2] - b[2]).abs().max())
            same = same and all(eq)
            print(f"M={m} N={n}: mu, cov, d_src equal {eq}; d_src max "
                  f"|diff| {gap:.3e}")
        print(f"this checkout ({root}) and other checkout ({other_root}): "
              f"{'equal' if same else 'different'} bits")
        return 0 if same else 1
    theirs = head_bits(dev, other.edge_head)
    print(f"HEAD_BITS {HEAD_BITS}")
    print(f"this checkout ({root}): {ours}")
    print(f"other checkout ({other_root}): {theirs}")
    return 0 if ours == theirs == HEAD_BITS else 1


if __name__ == "__main__":
    sys.exit(main())
