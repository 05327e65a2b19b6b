#!/usr/bin/env python3
"""The head forward's bit digest from this checkout's kernels and from
another checkout's, in one process on the same card; with
``--local-stats``, the bits of ``local_mean_cov``'s outputs and gradient;
with ``--bwd``, the digest of the fp32 backward kernels' outputs.

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
equal bit for bit, and exits 1 unless all are. With ``--bwd`` the recipe is
``bwd_digest``: numpy-drawn operands and cotangents at stage-4 widths
(B=2) through each checkout's fp32 ``head_bwd_kernel`` (on its own
``edge_head``'s graph and forward) and ``tail_bwd_kernel`` (gated, and the
plain stage at stage-1 widths), the sha256 of every gradient's bytes; it
prints both digests beside ``BWD_BITS`` and exits 1 unless all three are
equal. Needs a CUDA card; run from anywhere::

    python3 compare_head_bits.py --against /path/to/other/checkout
    python3 compare_head_bits.py --against /path/to/other --local-stats
    python3 compare_head_bits.py --against /path/to/other --bwd
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


# sha256 of bwd_digest's gradients from the fp32 backward kernels as they
# were before their bf16 instances were added (the product core's bf16
# transposed direction, the templated gate pass): that change keeps every
# bit of the fp32 instances. chip_smoke.py phase 2t checks it.
BWD_BITS = "420d06475890c97cd862a3ce8c5b9245aff70398d4f212b57082a47c109cc13a"


def bwd_digest(kernels, dev) -> str:
    """The fp32 head and tail backwards' gradients on numpy-drawn operands
    and cotangents (``kernels``: a checkout's ``edge_head``,
    ``head_bwd_kernel`` and ``tail_bwd_kernel``), hashed in order. No torch
    arithmetic runs before the kernels but the head's own forward (whose
    bits ``HEAD_BITS`` holds)."""
    import hashlib

    import numpy as np
    import torch

    edge_head, head_bwd, tail_bwd = kernels
    rng = np.random.RandomState(2025)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale + shift).astype(np.float32)).to(dev)

    digest = hashlib.sha256()

    def put(outs):
        for o in outs:
            if o is not None:
                digest.update(o.detach().cpu().numpy().tobytes())

    B, N, C, cf, four_fin, two_f, k = 2, 1024, 128, 256, 1024, 512, 10
    hk, window = k // 2, k // 2 + 1
    x = r(B, N, C)
    wn, ca = (r(window * C, four_fin, scale=0.03),
              r(C, four_fin, scale=0.03))
    am, wen = r(C, two_f, scale=0.03), r(k * C, two_f, scale=0.03)
    pcat, ppoint = r(B, N, 32), r(B, N, 32)
    idx, inte = edge_head(x, r(B, N, cf), wn, ca, r(B, four_fin, scale=0.1),
                          am, wen, r(B, two_f, scale=0.1), pcat, ppoint, k,
                          window)[:2]
    cts = (r(B, N, hk * four_fin), r(B, N, two_f),
           r(2, four_fin, scale=0.01), r(B, N, k * 16), r(B, N, k * 16),
           r(2, k * 32, scale=0.01))
    put(head_bwd(x, idx, inte, wn, ca, am, wen, pcat, ppoint, cts, k))
    for n, ff, tf, gated in ((N, four_fin, two_f, True),
                             (128, 128, 64, False)):
        two_fin = ff // 2
        args = (r(B, n, hk * ff), r(B, n, k * 64, scale=0.5) if gated
                else None, r(ff, scale=0.2, shift=1.0), r(ff, scale=0.1),
                r(64, two_fin, scale=0.125) if gated else None,
                r(two_fin, scale=0.1) if gated else None,
                r(two_fin, scale=0.2, shift=1.0) if gated else None,
                r(two_fin, scale=0.1) if gated else None,
                r(hk * ff, tf, scale=(hk * ff) ** -0.5))
        put(tail_bwd(*args, r(B, n, tf), k, True))
    return digest.hexdigest()


def _kernels():
    from pdgn_tpu_torch.ops.kernels.bilateral_tail import tail_bwd_kernel
    from pdgn_tpu_torch.ops.kernels.edge_head import (edge_head,
                                                      head_bwd_kernel)
    return edge_head, head_bwd_kernel, tail_bwd_kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout (holds pdgn_tpu_torch/)")
    ap.add_argument("--local-stats", action="store_true",
                    help="compare local_mean_cov's outputs and gradient "
                         "instead of the head's digest")
    ap.add_argument("--bwd", action="store_true",
                    help="compare the fp32 backward kernels' digest "
                         "instead of the head's")
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
    elif args.bwd:
        ours = bwd_digest(_kernels(), dev)
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
    if args.bwd:
        theirs = bwd_digest(_kernels(), dev)
        print(f"BWD_BITS {BWD_BITS}")
        print(f"this checkout ({root}): {ours}")
        print(f"other checkout ({other_root}): {theirs}")
        return 0 if ours == theirs == BWD_BITS else 1
    theirs = head_bits(dev, other.edge_head)
    print(f"HEAD_BITS {HEAD_BITS}")
    print(f"this checkout ({root}): {ours}")
    print(f"other checkout ({other_root}): {theirs}")
    return 0 if ours == theirs == HEAD_BITS else 1


if __name__ == "__main__":
    sys.exit(main())
