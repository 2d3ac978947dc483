"""The port's benchmark: one run of one cell, its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run loads, warms up the cell's own
shapes, measures for ``--seconds``, checks what the window produced
against the plain reference, and prints one JSON line: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a traced window. It exits 2, printing no result, without enough CUDA
devices, and 1 if the process loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402

# bytecode is a build cache like the kernels': a fixed directory inside the
# checkout, so that only a checkout's first run compiles the modules
PYCACHE = harness.ROOT / "_cache" / "pycache"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"portbench.drivers.{cell.kind}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    return report(cell, out, bool(args.trace))


def report(cell, out: dict, trace: bool, device_kind: str | None = None) -> int:
    """Judge the run, print the compared numbers on standard error and the
    result line last on standard output; 1, with no result, if the process
    loaded JAX or the JAX package."""
    bad = harness.forbidden_loaded()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    import torch

    check = {name: {"value": value, "limit": cell.limits.get(name)}
             for name, value in out["numbers"].items()}
    correct = all(c["limit"] is None or c["value"] <= c["limit"] for c in check.values())
    device = {
        "platform": "gpu",
        "kind": device_kind or torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(out["memory_peak_bytes"]),
    }
    breakdown = None
    if trace:
        art = out["artefacts"]
        art["power_limit"] = power_limit()
        metrics = harness.read_metrics(art)
        dev = art["trace"]
        device["busy_s"] = dev.busy_s() if dev is not None else 0.0
        device["window_s"] = dev.window_s if dev is not None else art["window_s"]
        breakdown = out["breakdown"]
        print(f"card: {art['power_limit']}", file=sys.stderr)
    else:
        metrics = out["e2e"]
    for line in harness.check_lines(check):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, out["attempted"], out["failed"], metrics, device,
                              check, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
