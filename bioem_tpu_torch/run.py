"""High-level entry point: build the single-device engine and run it.

PyTorch counterpart of ``bioem_tpu.run`` (reference ``main()`` dispatch,
main.cpp:80-89). One device; no autotuning yet (the defaults are the
JAX package's hand-tuned block sizes).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from .config import RunConfig
from .core.engine import BioEMEngine, Results
from .core.orientations import OrientationSet
from .io.map_io import ImageStack
from .io.model_io import Model
from .params import BioEMParams


def make_engine(
    p: BioEMParams,
    orients: OrientationSet,
    model: Model,
    images: ImageStack,
    cfg: Optional[RunConfig] = None,
    device=None,
) -> BioEMEngine:
    cfg = cfg or RunConfig.from_env()
    return BioEMEngine(p, orients, model, images, cfg, device=device)


def run_bioem(
    p: BioEMParams,
    orients: OrientationSet,
    model: Model,
    images: ImageStack,
    cfg: Optional[RunConfig] = None,
    device=None,
) -> Tuple[Results, dict]:
    """Run the full posterior computation; returns (results, perf stats).

    ``results.grid`` carries the CTF parameter grid for the output writers.
    """
    cfg = cfg or RunConfig.from_env()
    eng = make_engine(p, orients, model, images, cfg, device=device)
    t0 = time.perf_counter()
    state = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    run_s = time.perf_counter() - t0
    results = eng.results(state)
    results.grid = eng.grid
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    perf = {
        "run_s": run_s,
        "comparisons": comparisons,
        "comparisons_per_s": comparisons / run_s if run_s > 0 else float("inf"),
        "device": str(eng.device),
    }
    return results, perf
