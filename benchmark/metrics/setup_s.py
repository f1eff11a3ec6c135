"""Seconds from process start to the window's start: imports, the inputs,
the kernel library's load (its build on a checkout's first run), the engine
and the capturing first pass."""


def read(run):
    return run.setup_s
