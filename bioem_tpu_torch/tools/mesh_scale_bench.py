"""The same problem on a ladder of (images × orientations) meshes.

The port's counterpart of the JAX package's ``tools/mesh_scale_bench.py``.
The reference splits orientations over MPI ranks and reduces the
log-sum-exp at the end of the run; its paper publishes speedup against
ranks. This runs the production problem (``tools/problem.py``, cut to
``n_orient`` orientations and ``n_images`` images) on the meshes (1, 1),
(1, 2), (1, 4), … up to ``max_slots`` slots, and (2, max_slots/2) from 4
slots, and reports per row: comparisons/s (best of ``BENCH_REPEATS``
passes after a warm-up), per slot, the scaling efficiency against the
one-slot row, and the merge's host seconds (``ShardedBioEMEngine.merge_s``:
the copies of the slots' states to the host, the gather across processes
and the merge, the only communication of a pass).

The slots take this process's cards in turn (``slot_devices``), so on one
card several slots share it and run one after another: the rows then show
what the mesh costs, not what several cards gain. Each row holds itself to
the one-slot run: max |ΔlogP| ≤ 1e-6·max(1, max|logP|), or it raises.

    python -m bioem_tpu_torch.tools.mesh_scale_bench [max_slots] [n_orient] [n_images]

(defaults: 4 slots, 1088 orientations, 64 images). One JSON line per
mesh. The card, or the CPU with ``BIOEM_TPU_FORCE_CPU=1``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPEATS = int(os.environ.get("BENCH_REPEATS", 2))


def slot_devices(n: int, device=None) -> list:
    """``n`` slot devices: this process's cards in turn (several slots may
    share one), or the CPU."""
    import torch

    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def mesh_shapes(n: int) -> list:
    """(image shards, orientation shards): 1, 2, 4, … up to n slots along
    orientations (the reference's split), and (2, n/2) from 4 slots."""
    shapes = []
    s = 1
    while s <= n:
        shapes.append((1, s))
        s *= 2
    if n >= 4:
        shapes.append((2, n // 2))
    return shapes


def run_shape(shape, problem, device=None) -> tuple:
    """(row, logP) of one mesh."""
    from ..config import RunConfig
    from ..core.engine import BioEMEngine
    from ..parallel.mesh import ShardedBioEMEngine, make_bioem_mesh
    from .scale_bench import timed_pass

    p, orients, model, images, _ = problem
    n_slots = shape[0] * shape[1]
    cfg = RunConfig.from_env()
    cfg.autotune = False
    if n_slots == 1:
        eng = BioEMEngine(p, orients, model, images, cfg, device=slot_devices(1, device)[0])
    else:
        cfg.mesh_images, cfg.mesh_orient = shape
        eng = ShardedBioEMEngine(p, orients, model, images, cfg, mesh=make_bioem_mesh(
            *shape, devices=slot_devices(n_slots, device)))
    state, _ = timed_pass(eng)
    best = float("inf")
    for _ in range(REPEATS):
        state, t = timed_pass(eng)
        best = min(best, t)
    res = eng.results(state)
    if not np.isfinite(res.log_prob).all():
        raise RuntimeError(f"mesh {shape}: non-finite logP")
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    row = {
        "mesh": list(shape),
        "n_slots": n_slots,
        "comparisons_per_s": comparisons / best,
        "comparisons_per_s_per_slot": comparisons / best / n_slots,
        "run_s": best,
        "merge_s": getattr(eng, "merge_s", 0.0),
        "captures": eng.captures,
    }
    return row, res.log_prob


def ladder(max_slots: int = 4, n_orient: int = 1088, n_images: int = 64, device=None,
           say=None, **problem_kw) -> tuple:
    """(rows, logP per mesh) over :func:`mesh_shapes`; each row holds
    itself to the one-slot run (raises beyond 1e-6·max(1, max|logP|))."""
    from .problem import build_problem

    problem = build_problem(n_orient=n_orient, **{"n_img": n_images, **problem_kw})
    rows, logps = [], []
    for shape in mesh_shapes(max_slots):
        row, logp = run_shape(shape, problem, device)
        ref = logps[0] if logps else logp
        diff = float(np.max(np.abs(logp - ref)))
        lim = 1e-6 * max(1.0, float(np.max(np.abs(ref))))
        row["logp_max_abs_diff_vs_1slot"] = diff
        if diff >= lim:
            raise RuntimeError(f"mesh {shape}: logP differs from the one-slot run by {diff:.3e} "
                               f"(limit {lim:.3e})")
        base = (rows[0] if rows else row)["comparisons_per_s"]
        row["scaling_efficiency_pct"] = 100.0 * row["comparisons_per_s"] / (base * row["n_slots"])
        rows.append(row)
        logps.append(logp)
        if say:
            say(json.dumps(row))
    return rows, logps


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    ladder(int(args[0]) if len(args) > 0 else 4, int(args[1]) if len(args) > 1 else 1088,
           int(args[2]) if len(args) > 2 else 64, say=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
