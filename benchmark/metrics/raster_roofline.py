"""G4's share of its roofline (%): the counted bound of the traced passes'
raster projection (``raster_counts.raster_work``: f32 operations over the
f32 peak, or bytes over HBM's rate) over the device time of the
``raster_projection_kernel*`` kernels in the traced window."""

from benchmark.registry import load_module


def read(run):
    if run.trace is None or not run.trace.passes:
        return None
    work = load_module("metrics", "raster_counts").raster_work(run.problem)
    t = sum(b - a for name, a, b in run.trace.kernels if "raster_projection_kernel" in name) * 1e-6
    if work is None or t <= 0:
        return None
    return 100.0 * run.trace.passes * work["bound_s"] / t
