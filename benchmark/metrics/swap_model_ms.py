"""Host ms of ``eng.swap_model`` (the median over the window's calls),
timed by the harness around the call."""

import statistics


def read(run):
    return 1e3 * statistics.median(run.swap_s) if run.swap_s else None
