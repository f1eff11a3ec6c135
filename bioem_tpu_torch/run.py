"""High-level entry point: autotune, build the engine, run it.

PyTorch counterpart of ``bioem_tpu.run`` (reference ``main()`` dispatch,
main.cpp:80-89): the single-device engine, or a mesh of slots
(parallel/mesh.py) when ``cfg.mesh_images × cfg.mesh_orient > 1``.
Problems large enough to amortise the timing runs are autotuned first
(runtime/autotune.py), as the reference autotunes every GPU run.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from .config import RunConfig, resolve_device
from .core.engine import BioEMEngine, Results
from .core.orientations import OrientationSet
from .io.map_io import ImageStack
from .io.model_io import Model
from .params import BioEMParams, make_ctf_grid
from .utils.timestat import RECORDER, profile_trace, traced

# Below this many (image × orientation × ctf) comparisons a first run's
# tuning costs more than the tuned pass saves. Measured on an H100 at the
# production problem (224 px, D=21, 2.2 M comparisons) in two runs: tuning
# 8.75–9.83 s, the tuned pass 0.67–1.06 s faster than the default, so one
# run repays the tuning from 18–33 M comparisons (its cost is fixed:
# SPAN_COMPARISONS per candidate); later runs of the shape read the winner
# from the cache. Smaller runs (tests, golden cases) stay on the defaults.
AUTOTUNE_MIN_COMPARISONS = 20_000_000


@traced("bioem.autotune")
def maybe_autotune(p, orients, model, images, cfg: RunConfig, device=None) -> RunConfig:
    """Resolve cfg.autotune (None = auto by problem size) and run the tuner
    (the reference autotunes by default on every GPU run,
    autotuner.cpp:16-50, bioem.cpp:731-737). A mesh run in one process
    tunes on its first slot; a multi-process mesh run keeps the defaults
    unless forced (each process would time and cache on its own, and a
    different winner per process would break the merge's shapes). Span
    ``bioem.autotune``: the decision, and the tuner when it runs."""
    from .parallel.distributed import process_count

    if cfg.mesh_images * cfg.mesh_orient != 1 and process_count() > 1:
        if not cfg.autotune:
            return cfg
        import warnings

        warnings.warn("autotune forced on a multi-process run: every process must reach "
                      "the same winner (share the autotune cache file)", RuntimeWarning)
    on = cfg.autotune
    if on is None:
        # Size at the shape the engine will actually run: debug caps
        # (BIOEM_DEBUG_BREAK/NMAPS) shrink the problem.
        grid_n = make_ctf_grid(p).n
        n_orient = orients.n
        if cfg.debug_break:
            n_orient = min(n_orient, cfg.debug_break)
            grid_n = min(grid_n, cfg.debug_break)
        n_img = images.maps.shape[0]
        if cfg.debug_nmaps:
            n_img = min(n_img, cfg.debug_nmaps)
        on = n_orient * grid_n * n_img >= AUTOTUNE_MIN_COMPARISONS
    if not on:
        return cfg
    from .runtime.autotune import autotune_config

    return autotune_config(
        p, orients, model, images, cfg, verbose=cfg.debug_output >= 1, device=device
    )


def make_engine(
    p: BioEMParams,
    orients: OrientationSet,
    model: Model,
    images: ImageStack,
    cfg: Optional[RunConfig] = None,
    device=None,
    model_layout: Optional[dict] = None,
    mesh=None,
) -> BioEMEngine:
    """The single-device engine, or a :class:`ShardedBioEMEngine` on a
    ``cfg.mesh_images × cfg.mesh_orient`` mesh of this ``device``'s kind
    (parallel/mesh.make_bioem_mesh) when that is more than 1;
    ``model_layout`` pads the model arrays to a layout shared by several
    models (rank.common_model_layout). ``mesh`` (parallel/mesh.BioEMMesh)
    places the slots on other devices than that default, e.g. several
    slots on one card."""
    cfg = cfg or RunConfig.from_env()
    if cfg.mesh_images * cfg.mesh_orient > 1:
        from .parallel.mesh import ShardedBioEMEngine

        return ShardedBioEMEngine(p, orients, model, images, cfg, mesh=mesh,
                                  model_layout=model_layout, device=device)
    return BioEMEngine(p, orients, model, images, cfg, device=device, model_layout=model_layout)


def run_bioem(
    p: BioEMParams,
    orients: OrientationSet,
    model: Model,
    images: ImageStack,
    cfg: Optional[RunConfig] = None,
    device=None,
) -> Tuple[Results, dict]:
    """Run the full posterior computation; returns (results, perf stats).

    ``device`` None is the card, or the CPU with ``BIOEM_TPU_FORCE_CPU``
    (config.resolve_device: no card and no switch raises).
    ``results.grid`` carries the CTF parameter grid for the output writers;
    ``perf["config"]`` is the configuration that ran (after autotuning and
    the engine's own resolution of its defaults); ``perf["n_devices"]``
    the distinct devices of its mesh (1 alone); ``perf["autotune_s"]``
    the seconds of the tuning decision and the tuner before the pass (the
    ``bioem.autotune`` span); ``perf["engine"]`` the
    engine that ran (the DEBUG_PROB dump reuses its banks).
    """
    cfg = cfg or RunConfig.from_env()
    device = resolve_device(device)
    cfg = maybe_autotune(p, orients, model, images, cfg, device=device)
    autotune_s = RECORDER.durations("bioem.autotune")[-1]
    eng = make_engine(p, orients, model, images, cfg, device=device)
    t0 = time.perf_counter()
    with profile_trace(cfg.profile_dir):
        state = eng.run()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
    run_s = time.perf_counter() - t0
    results = eng.results(state)
    results.grid = eng.grid
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    perf = {
        "run_s": run_s,
        "autotune_s": autotune_s,  # set-up before the pass
        "comparisons": comparisons,
        "comparisons_per_s": comparisons / run_s if run_s > 0 else float("inf"),
        "device": str(eng.device),
        "n_devices": getattr(eng, "n_devices", 1),
        "engine": eng,
        "config": {
            "orient_block": eng.o_block,
            "use_kernels": eng.use_kernels,
            "fused_lse": eng.fused_lse,
            "fused_batched": eng.fused_batched,
            "kernel_img_tile": eng.i_block,
        },
    }
    return results, perf
