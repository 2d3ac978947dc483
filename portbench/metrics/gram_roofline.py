"""The trainer's gathers, normal equations and Gramians against their
bound: roofline.als_gram_cost of every iteration in the window through
roofline.ops_bound, over the profiler's time of every kernel of the window
that is not a solve's."""

from portbench import roofline
from portbench.metrics._common import solve_kernel

UNIT = "%"


def read(art):
    trace = art.get("trace")
    if art.get("kind") != "als_train" or trace is None or not art.get("generations"):
        return None
    seconds = trace.kernel_seconds(lambda n: not solve_kernel(n))
    if seconds <= 0:
        return None
    bound_ms, _ = roofline.ops_bound(*art["gram_cost"])
    iterations = art["iterations"] * len(art["generations"])
    return 100.0 * bound_ms * 1e-3 * iterations / seconds
