"""Production-scale orientation grids on one card: BASELINE configs 2-3.

The port's counterpart of the JAX package's ``tools/scale_bench.py``. The
production problem (``tools/problem.py``: 224² pixels, 64 images, 8 CTFs,
a 21×21 displacement lattice) at 4608 and 36864 super-Fibonacci
orientations (the reference ships lists of exactly these sizes and
documents a 4608-orientation production run), each with
``WRITE_PROB_ANGLES`` 0 and 30, autotuning off. Per configuration: one
warm-up pass (which builds the kernels and captures the block step), then
the best of ``BENCH_REPEATS`` (default 2) timed passes, each ending in a
synchronisation of the card; comparisons/s; and the card's peak memory
(``torch.cuda.max_memory_allocated``, reset before the engine is built;
it includes what the process already held then, ``card_mb_at_start``).

With the per-angle slabs on, the state carries two (I, n_orient) f64
slabs updated per block (64 × 36864 × 8 B × 2 = 38 MB at 36864): this
shows whether their update holds the pass back at scale.

    python -m bioem_tpu_torch.tools.scale_bench [n_orient ...] [--out FILE]

(default 4608 36864). One JSON line per configuration; ``--out`` also
writes the list to FILE. The card, or the CPU with ``BIOEM_TPU_FORCE_CPU=1``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

N_IMG = int(os.environ.get("BENCH_NIMG", 64))
REPEATS = int(os.environ.get("BENCH_REPEATS", 2))


def reset_peak(dev):
    """Start the card's peak-memory count; returns the memory the process
    already holds there, MiB (None on the CPU): the peak includes it."""
    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return round(torch.cuda.memory_allocated(dev) / 2**20, 1)


def peak_card_mb(dev):
    """Peak card memory allocated since :func:`reset_peak`, MiB (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)


def timed_pass(eng) -> tuple:
    """(state, seconds) of one pass of ``eng`` ending in a synchronisation."""
    t0 = time.perf_counter()
    state = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return state, time.perf_counter() - t0


def run_one(n_orient: int, write_angles: int, repeats: int = REPEATS, device=None,
            **problem_kw) -> dict:
    """One configuration; ``problem_kw`` goes to ``problem.build_problem``
    (default: the production problem with ``N_IMG`` images). The record
    holds ``log_prob`` beside the JSON line's fields."""
    from ..config import RunConfig, resolve_device
    from ..run import make_engine
    from .problem import build_problem

    dev = resolve_device(device)
    p, orients, model, images, _ = build_problem(n_orient=n_orient,
                                                 **{"n_img": N_IMG, **problem_kw})
    p.write_angles = write_angles
    cfg = RunConfig.from_env()
    cfg.autotune = False  # the scale's behaviour, not the tuner's choices
    held_mb = reset_peak(dev)
    eng = make_engine(p, orients, model, images, cfg, device=dev)
    state, _ = timed_pass(eng)  # warm-up: kernels built, block step captured
    best = float("inf")
    for _ in range(repeats):
        state, t = timed_pass(eng)
        best = min(best, t)
    res = eng.results(state)
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    return {
        "n_orient": n_orient,
        "write_prob_angles": bool(write_angles),
        "comparisons": comparisons,
        "seconds": best,
        "comparisons_per_s": comparisons / best,
        "peak_card_mb": peak_card_mb(dev),
        "card_mb_at_start": held_mb,
        "logp_finite": bool(np.isfinite(res.log_prob).all()
                            and (res.angle_log is None or np.isfinite(res.angle_log).all())),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "log_prob": res.log_prob,
    }


def json_line(rec: dict) -> str:
    return json.dumps({k: v for k, v in rec.items() if k != "log_prob"})


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    rows = []
    for n in [int(a) for a in args] or [4608, 36864]:
        for wa in (0, 30):
            rows.append(run_one(n, wa))
            print(json_line(rows[-1]), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump([json.loads(json_line(r)) for r in rows], f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
