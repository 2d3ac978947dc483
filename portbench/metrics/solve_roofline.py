"""The trainer's batched Cholesky solves against their bound:
roofline.als_solve_cost of every iteration in the window through
roofline.ops_bound, over the profiler's time of the factorisation and
triangular-solve kernels."""

from portbench import roofline
from portbench.metrics._common import solve_kernel

UNIT = "%"


def read(art):
    trace = art.get("trace")
    if art.get("kind") != "als_train" or trace is None or not art.get("generations"):
        return None
    seconds = trace.kernel_seconds(solve_kernel)
    if seconds <= 0:
        return None
    bound_ms, _ = roofline.ops_bound(*art["solve_cost"])
    iterations = art["iterations"] * len(art["generations"])
    return 100.0 * bound_ms * 1e-3 * iterations / seconds
