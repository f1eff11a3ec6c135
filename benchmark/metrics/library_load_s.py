"""Seconds of the program's first load of its kernel library in the
process: its ``bioem.library`` span (the sources' hash, nvcc when the hash
is new, dlopen and the signatures). None where the program records no such
span."""


def read(run):
    try:
        from bioem_tpu_torch.utils.timestat import RECORDER
    except ImportError:
        return None
    d = RECORDER.durations("bioem.library")
    return d[0] if d else None
