"""Comparisons completed in the window over the window's seconds: from the
window's start to the end of its last pass (host clock). One comparison is
one (image, orientation, CTF) scored over the whole displacement lattice;
a pass counts once its results are on the host."""


def read(run):
    return run.comparisons / run.window_s if run.window_s > 0 else None
