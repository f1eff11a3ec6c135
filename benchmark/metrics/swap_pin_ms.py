"""Host ms of a model swap's page-locking of its fields: the median of the
program's ``bioem.place.pin`` spans inside ``bioem.swap_model``. None where
the program records no such span."""

import statistics


def read(run):
    try:
        from bioem_tpu_torch.utils.timestat import RECORDER
    except ImportError:
        return None
    d = RECORDER.durations("bioem.place.pin", parent="bioem.swap_model")
    return 1e3 * statistics.median(d) if d else None
