"""The top-N scan and its merge against their bound: for each launch of the
window, roofline.kernel_bound of its batch rows over the whole catalog at
the plane's dtype, its answers written once; over the profiler's time of
the scan and merge kernels."""

from portbench import roofline
from portbench.metrics._common import scan_kernel

UNIT = "%"


def read(art):
    trace = art.get("trace")
    if art.get("kind") != "als_serve" or trace is None or not art.get("scan_batches"):
        return None
    seconds = trace.kernel_seconds(scan_kernel)
    if seconds <= 0:
        return None
    bound_ms = 0.0
    for (_key, b), launches in art["scan_batches"].items():
        ms, _ = roofline.kernel_bound(art["score_dtype"], b, art["features"], art["n_items"],
                                      b * art["how_many"] * 8)
        bound_ms += ms * launches
    return 100.0 * bound_ms * 1e-3 / seconds
