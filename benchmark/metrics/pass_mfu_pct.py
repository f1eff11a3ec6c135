"""The whole pass's share (%) of the chip's peak: the least time one H100
could take for the pass's counted work (counts.pass_bounds: comparisons,
projection, f64 glue, from the problem's shapes) over the median pass of
the window (host clock)."""

import statistics

from benchmark.counts import pass_bounds


def read(run):
    if not run.pass_s:
        return None
    return 100.0 * pass_bounds(run.problem)["pass"] / statistics.median(run.pass_s)
