"""Kernels launched on the card per pass in the traced window (the traced
passes are whole passes of the cell's fixed work, so the count does not
depend on how the program cuts a pass into blocks)."""


def read(run):
    if run.trace is None or not run.trace.passes or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.passes
