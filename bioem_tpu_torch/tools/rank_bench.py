"""BASELINE config 4: the amortisation of ranking many models.

The port's counterpart of the JAX package's ``tools/rank_bench.py``. Ranks
N candidate models against one image set twice over:

* **reuse** (``rank.rank_models``'s path): one engine; the image FFT bank,
  the orientation blocks and the captured block step are made once, and
  each further model only swaps its arrays in (a common padded layout,
  one capture);
* **naive estimate**: the first model's cold time (engine build, kernel
  build, capture and first pass) × N, what N separate runs would cost (the
  reference's model-comparison workflow runs BioEM once per model).

The problem is the production problem (``tools/problem.py``) at
``n_orient`` super-Fibonacci orientations and ``n_images`` images; the
candidates are its model and copies of it with every point moved by
N(0, 0.8 Å) (seed 7).

    python -m bioem_tpu_torch.tools.rank_bench [n_models] [n_images] [n_orient]

(defaults 10 1000 576). Prints one JSON line. The card, or the CPU with
``BIOEM_TPU_FORCE_CPU=1``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def candidates(model0, n_models: int) -> list:
    """``model0`` and ``n_models − 1`` copies with every point moved by
    N(0, 0.8 Å) (seed 7; same point count, so the common layout pads
    nothing)."""
    from ..io.model_io import Model

    rng = np.random.default_rng(7)
    models = [model0]
    for _ in range(n_models - 1):
        pts = model0.points + rng.normal(0, 0.8, model0.points.shape).astype(np.float32)
        models.append(Model(pts, model0.radii, model0.densities, model0.norm_den))
    return models


def bench(n_models: int = 10, n_images: int = 1000, n_orient: int = 576, device=None,
          **problem_kw) -> tuple:
    """(record, per-model logP list); ``problem_kw`` goes to
    ``problem.build_problem``."""
    import torch

    from ..config import RunConfig, resolve_device
    from ..rank import common_model_layout
    from ..run import make_engine
    from .problem import build_problem
    from .scale_bench import timed_pass

    dev = resolve_device(device)
    p, orients, model0, images, _ = build_problem(n_orient=n_orient,
                                                  **{"n_img": n_images, **problem_kw})
    models = candidates(model0, n_models)
    cfg = RunConfig.from_env()
    cfg.autotune = False
    layout = common_model_layout(p, models, cfg.projection)

    t0 = time.perf_counter()
    eng = make_engine(p, orients, models[0], images, cfg, device=dev, model_layout=layout)
    state, _ = timed_pass(eng)
    t_cold = time.perf_counter() - t0  # build + kernels + capture + first pass
    log_probs = [eng.results(state).log_prob]
    t_swaps = []
    for m in range(1, n_models):
        t0 = time.perf_counter()
        banks = eng.swap_model(models[m])
        state = eng.run(banks=banks)
        log_probs.append(eng.results(state).log_prob)  # the host copy synchronises
        t_swaps.append(time.perf_counter() - t0)
    reuse_s = t_cold + sum(t_swaps)
    naive_s = n_models * t_cold
    comparisons = n_models * eng.n_orient * eng.n_ctf * eng.n_img
    rec = {
        "n_models": n_models,
        "n_images": n_images,
        "n_orient": n_orient,
        "cold_s": t_cold,
        "mean_swap_run_s": float(np.mean(t_swaps)) if t_swaps else None,
        "reuse_total_s": reuse_s,
        "naive_estimate_s": naive_s,
        "speedup_vs_naive": naive_s / reuse_s,
        "comparisons_per_s_reuse": comparisons / reuse_s,
        "captures": eng.captures,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return rec, log_probs


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    n_models = int(args[0]) if len(args) > 0 else 10
    n_images = int(args[1]) if len(args) > 1 else 1000
    n_orient = int(args[2]) if len(args) > 2 else 576
    rec, _ = bench(n_models, n_images, n_orient)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
