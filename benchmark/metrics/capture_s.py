"""Host seconds the first pass (which captures the block step) took
beyond the median pass of the window."""

import statistics


def read(run):
    if not run.pass_s or run.first_pass_s <= 0:
        return None
    return run.first_pass_s - statistics.median(run.pass_s)
