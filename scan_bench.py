#!/usr/bin/env python3
"""Phase 2, 5 or 14 of chip_smoke.py alone, on one card: the top-N scan
kernels, or the k-means Lloyd sweep, against their plain versions, with
their times; or the default request path (serving-front).

    python3 scan_bench.py                        # the scans, this checkout's oryx_tpu_torch
    python3 scan_bench.py --root DIR             # the package of another checkout
    python3 scan_bench.py --phase kmeans [--root DIR]   # the sweep
    python3 scan_bench.py --phase front                 # the request path

The cases, checks, timers and inputs are chip_smoke's (``phase_kernels``
or ``phase_kmeans_kernels`` at its default sizes and seed); each case
prints one JSON line and a failed check raises. Another checkout's sweep
is called through ``pallas_kmeans.sweep`` alone and held against this
checkout's ``sweep_plain``. To compare two versions of the
kernels, run it on both checkouts in one session on one card, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE, help="checkout whose oryx_tpu_torch to load")
    p.add_argument("--phase", choices=("scan", "kmeans", "front"), default="scan")
    opts = p.parse_args()
    root = os.path.abspath(opts.root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: scan_bench.py runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from oryx_tpu_torch.ops.pallas_kmeans import sweep_plain

    if root != HERE:  # the other checkout's package under the same name
        for name in [m for m in sys.modules if m.split(".")[0] == "oryx_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, root)
    from oryx_tpu_torch.ops import pallas_kmeans as pk
    from oryx_tpu_torch.ops import streaming_topn as stn

    for mod in (stn, pk):
        if not mod.__file__.startswith(root + os.sep):
            raise RuntimeError(f"loaded {mod.__file__}, not the package under {root}")
    cs.full_float32(torch)
    args = cs.parse_args([])
    cs.emit({"root": root, "phase": opts.phase, "nvidia_smi": cs.nvidia_smi_line()})
    if opts.phase == "front":
        from oryx_tpu_torch.ops import _build

        _build.build()  # the IVF build's Lloyd sweep
        cs.phase_serving_front(torch, args, stn, pk, args.seed)
        return 0
    if opts.phase == "kmeans":
        if root != HERE:
            # another checkout's sweep, through its public entry points only,
            # held against this checkout's plain version; its plan is not
            # printed
            pk = types.SimpleNamespace(
                sweep=pk.sweep, padded_k=pk.padded_k, pad_to_block=pk.pad_to_block,
                launch_counts=pk.launch_counts, sweep_plain=sweep_plain,
                sweep_plan=lambda *a: (0, None),
            )
        cs.phase_kmeans_kernels(torch, pk, args.seed)
        return 0
    y = cs.factors(np.random.default_rng(args.seed), args.items, args.features)
    cs.phase_kernels(torch, stn, y, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
