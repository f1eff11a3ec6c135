"""Device ms per pass of every kernel that is neither comparison nor
projection (G1, G2 and the graph's index and copy kernels) in the traced
window."""

from benchmark.kernels import seconds_by_layer


def read(run):
    if run.trace is None or not run.trace.passes:
        return None
    t = seconds_by_layer(run.trace.kernels)["glue"]
    return 1e3 * t / run.trace.passes if t > 0 else None
