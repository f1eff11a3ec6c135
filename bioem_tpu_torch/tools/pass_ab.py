"""A/B of whole passes against another checkout's, on one card.

    python -m bioem_tpu_torch.tools.pass_ab OTHER_ROOT

Runs one child process per turn, in turns other, this, this, other, each
in its checkout's root so that it imports that checkout's
``bioem_tpu_torch`` and builds that checkout's kernels. A child measures,
on the card, with APIs every checkout since the CUDA graph has:

* the production problem (``tools/problem.py``, seed 0) on the default
  kernel pass (K1, o_block 8, no autotuning): the best of three passes
  (``BioEMEngine.run``, after one pass that captures the block step),
  each ending in a synchronise; the same on K4 at o_block 16, the
  configuration the autotuner chooses for this problem (``k4_o16_s``);
* one replayed block of it: 32 replays timed (wall ms per block), then 32
  more under torch.profiler (the card's busy ms per block, the sum of its
  kernels' times, and the kernels launched per block);
* the reference's production grid
  (``problem.REFERENCE_GRID``: 4608 × 32 CTFs × 64 images at D = 81) on the
  same pass: the best of two passes after a capturing one.

Each child prints one JSON line; this prints them all, with the card's
name and power limit, and a line of each side's mean per field.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core.engine import BioEMEngine
from bioem_tpu_torch.ops import _build
from bioem_tpu_torch.tools.problem import REFERENCE_GRID, build_problem

_build.load()
cfg = RunConfig(use_kernels=True, autotune=False)


def best_pass(problem, reps, cfg=cfg):
    p, orients, model, images, _ = problem
    eng = BioEMEngine(p, orients, model, images, cfg, device="cuda")
    eng.run()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return eng, best


out = {}
problem = build_problem()
_eng, out["k4_o16_s"] = best_pass(problem, 3, RunConfig(
    use_kernels=True, autotune=False, fused_batched=True, orient_block=16))
del _eng
eng, out["production_s"] = best_pass(problem, 3)
eng._graph_load(eng.initial_state(), 0)
for _ in range(4):
    eng._replay()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(32):
    eng._replay()
torch.cuda.synchronize()
out["block_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 32
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(32):
        eng._replay()
    torch.cuda.synchronize()
kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False) and not e.name.startswith("bioem.")]
out["block_busy_ms"] = sum(e.time_range.elapsed_us() for e in kern) * 1e-3 / 32
out["block_kernels"] = len(kern) / 32
del eng
_eng, out["reference_s"] = best_pass(build_problem(**REFERENCE_GRID), 2)
print(json.dumps(out), flush=True)
'''


def run_child(root: str) -> dict:
    """One child in ``root``; its JSON line."""
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          cwd=os.path.abspath(root), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the child in {root} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    from .bench import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(card_line(), flush=True)
    rows = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        rec = run_child(a.other if side == "other" else here)
        rows[side].append(rec)
        print(json.dumps({"side": side, **rec}), flush=True)
    for side, recs in rows.items():
        mean = {k: sum(r[k] for r in recs) / len(recs) for k in recs[0]}
        print(json.dumps({"side": side, "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
