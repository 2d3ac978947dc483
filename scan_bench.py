#!/usr/bin/env python3
"""Phase 2 of chip_smoke.py alone: the top-N scan kernels against their
plain versions, with their times, on one card.

    python3 scan_bench.py              # this checkout's oryx_tpu_torch
    python3 scan_bench.py --root DIR   # the package of another checkout

The cases, checks, timers and inputs are chip_smoke's
(``phase_kernels`` at its default sizes and seed); each case prints one
JSON line and a failed check raises. To compare two versions of the
kernels, run it on both checkouts in one session on one card, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE, help="checkout whose oryx_tpu_torch to load")
    root = os.path.abspath(p.parse_args().root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: scan_bench.py runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, root)
    from oryx_tpu_torch.ops import streaming_topn as stn

    if not stn.__file__.startswith(root + os.sep):
        raise RuntimeError(f"loaded {stn.__file__}, not the package under {root}")
    cs.full_float32(torch)
    args = cs.parse_args([])
    y = cs.factors(np.random.default_rng(args.seed), args.items, args.features)
    cs.emit({"root": root, "nvidia_smi": cs.nvidia_smi_line()})
    cs.phase_kernels(torch, stn, y, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
