"""Host seconds of ``run.make_engine`` (the banks, the kernel library's
load, the orientation blocks)."""


def read(run):
    return run.engine_build_s if run.engine_build_s > 0 else None
