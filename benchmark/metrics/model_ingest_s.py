"""Seconds of the program's first model read: its ``bioem.model.read`` span
(io/model_io.read_model: the file's read, the voxels' coordinates and the
density-mass centring). None where the program records no such span."""


def read(run):
    try:
        from bioem_tpu_torch.utils.timestat import RECORDER
    except ImportError:
        return None
    d = RECORDER.durations("bioem.model.read")
    return d[0] if d else None
