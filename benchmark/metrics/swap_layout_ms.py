"""Host ms of a model swap's layout (the radius grouping and the stencil
spectra on the host): the median of the program's
``bioem.swap_model.layout`` spans. None where the program records no such
span."""

import statistics


def read(run):
    try:
        from bioem_tpu_torch.utils.timestat import RECORDER
    except ImportError:
        return None
    d = RECORDER.durations("bioem.swap_model.layout")
    return 1e3 * statistics.median(d) if d else None
