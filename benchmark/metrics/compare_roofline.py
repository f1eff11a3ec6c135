"""The comparison kernels' share of their roofline (%): the frozen bound
of the traced passes' comparisons (counts.compare_bound: stage 1 in 3xTF32
on the tensor cores, the rest in f32) over the device time of the
comparison kernels in the traced window."""

from benchmark.counts import pass_bounds
from benchmark.kernels import seconds_by_layer


def read(run):
    if run.trace is None:
        return None
    t = seconds_by_layer(run.trace.kernels)["compare"]
    if t <= 0:
        return None
    return 100.0 * run.trace.passes * pass_bounds(run.problem)["compare"] / t
