#!/usr/bin/env python3
"""Phase 2, 5, 9b, 9c, 14 or 15 of chip_smoke.py alone, on one card: the
top-N scan kernels, or the k-means Lloyd sweep, against their plain
versions, with their times; the fault, shm and TCP buses under the ALS
loop (buses); four tenants on one serving layer, an online experiment
and a rollback (tenants); the default request path (serving-front); or the native
host code (native-host, after ivf-serving, whose catalog and index it
reuses: the parser, formatters, store and tiered IVF cell store against
their Python paths).

    python3 scan_bench.py                        # the scans, this checkout's oryx_tpu_torch
    python3 scan_bench.py --root DIR             # the package of another checkout
    python3 scan_bench.py --phase kmeans [--root DIR]   # the sweep
    python3 scan_bench.py --phase buses                 # conf/chaos-example.conf, shm and tcp
    python3 scan_bench.py --phase tenants               # tenants, experiment, rollback
    python3 scan_bench.py --phase front                 # the request path
    python3 scan_bench.py --phase front --store python  # ... X/Y in the Python store
    python3 scan_bench.py --phase native                # ivf-serving, the native host code

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
    p.add_argument("--phase", choices=("scan", "kmeans", "buses", "tenants", "front", "native"), default="scan")
    p.add_argument("--store", choices=("default", "python"), default="default",
                   help="python: the ALS serving model keeps X/Y in the pure-Python "
                   "FeatureVectors instead of make_feature_vectors()'s store")
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
    cs.emit({"root": root, "phase": opts.phase, "store": opts.store,
             "nvidia_smi": cs.nvidia_smi_line()})
    if opts.store == "python":
        from oryx_tpu_torch.app.als import serving_model
        from oryx_tpu_torch.app.als.common import FeatureVectors

        serving_model.make_feature_vectors = FeatureVectors
    if opts.phase == "buses":
        from oryx_tpu_torch import native
        from oryx_tpu_torch.ops import _build

        _build.build()  # the scans the serving processes launch
        native.get_library()  # built once, before the layers' processes load it
        cs.phase_buses(args.seed)
        return 0
    if opts.phase == "tenants":
        from oryx_tpu_torch import native
        from oryx_tpu_torch.ops import _build

        _build.build()  # the ALS tenants' scans and the k-means tenant's sweep
        native.get_library()  # the native front
        cs.phase_tenants(torch, stn, pk, args.seed)
        return 0
    if opts.phase == "front":
        from oryx_tpu_torch.ops import _build

        _build.build()  # the IVF build's Lloyd sweep
        cs.phase_serving_front(torch, args, stn, pk, args.seed)
        return 0
    if opts.phase == "native":
        from oryx_tpu_torch.ops import _build

        _build.build()  # the IVF build's Lloyd sweep
        ivf_srv = cs.phase_ivf_serving(torch, args, stn, pk, args.seed)
        cs.phase_native_host(torch, args, cs.nvidia_smi_line(), args.seed,
                             catalog=ivf_srv["catalog"])
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
