#!/usr/bin/env python3
"""The head forward's bit digest from this checkout's kernels and from
another checkout's, in one process on the same card.

``pdgn_tpu_torch.ops.kernels.edge_head.head_bits`` draws the head's
operands with numpy and hashes the head's outputs. This script takes that
recipe from this checkout and runs it on this checkout's ``edge_head``; then
it unloads the package, imports the one under ``--against`` (an earlier
commit unpacked with ``git archive``, say), which builds its own kernels
into its own build directory, and runs the same recipe on that checkout's
``edge_head``. Prints both digests beside ``HEAD_BITS``; exits 1 unless all
three are equal. Needs a CUDA card; run from anywhere::

    python3 compare_head_bits.py --against /path/to/other/checkout
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout (holds pdgn_tpu_torch/)")
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
    theirs = head_bits(dev, other.edge_head)
    print(f"HEAD_BITS {HEAD_BITS}")
    print(f"this checkout ({root}): {ours}")
    print(f"other checkout ({other_root}): {theirs}")
    return 0 if ours == theirs == HEAD_BITS else 1


if __name__ == "__main__":
    sys.exit(main())
