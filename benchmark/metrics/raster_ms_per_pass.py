"""Device ms per pass of the raster projection: the ``raster_projection_kernel*``
kernels (G4) and cuFFT's kernels in the traced window."""


def read(run):
    if run.trace is None or not run.trace.passes:
        return None
    t = sum(b - a for name, a, b in run.trace.kernels
            if "raster_projection_kernel" in name or "fft" in name.lower())
    return 1e-3 * t / run.trace.passes if t > 0 else None
