"""Share (%) of the traced window in which no operation runs on the card:
one minus the union of the device operations' intervals over the window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
