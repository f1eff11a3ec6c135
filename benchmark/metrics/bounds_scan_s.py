"""Seconds of the program's first out-of-frame census: its ``bioem.bounds``
span (the engine's count of the (orientation, point) pairs the snap drops,
which BioEM warns about). None where the program records no such span."""


def read(run):
    try:
        from bioem_tpu_torch.utils.timestat import RECORDER
    except ImportError:
        return None
    d = RECORDER.durations("bioem.bounds")
    return d[0] if d else None
