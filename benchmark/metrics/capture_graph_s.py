"""Seconds of the program's first capture of its block step as a CUDA
graph: its ``bioem.capture.graph`` span (``torch.cuda.graph``'s entry,
which waits for the warm-up step's kernels, the capture and the graph's
instantiation). None where the program records no such span."""


def read(run):
    try:
        from bioem_tpu_torch.utils.timestat import RECORDER
    except ImportError:
        return None
    d = RECORDER.durations("bioem.capture.graph")
    return d[0] if d else None
