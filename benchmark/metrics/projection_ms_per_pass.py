"""Device ms per pass of the projection's kernels (K2, G3, G4 and cuFFT)
in the traced window."""

from benchmark.kernels import seconds_by_layer


def read(run):
    if run.trace is None or not run.trace.passes:
        return None
    t = seconds_by_layer(run.trace.kernels)["projection"]
    return 1e3 * t / run.trace.passes if t > 0 else None
