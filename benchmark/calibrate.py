"""Readings that the check's limits are set from, on the card, in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--passes 2] [--out chiprun_out/calib.jsonl]

For each of ``--seeds``: the cell's set-up and ``--passes`` passes of its
timed path (every candidate once, for a ranking mix), then the check's
numbers for those outputs (the program's readings: the lower end of each
limit). For each of ``--control-seeds``: the control, the plain reference
computed with its two cross-correlation contractions in TF32 and put in
the program's place, judged by the same check (its readings: the upper
end). One JSON line per reading, to standard output and to ``--out``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

from benchmark import harness
from benchmark.registry import load_module, reference
from benchmark.run import ROOT, cache_env


def control_outputs(prob, device) -> list:
    """Outputs in the program's form, (model, log_prob (I,), best (I, 4),
    best log-probability (I,)), from the TF32 reference over the checked
    images."""
    ref = reference(prob.cfg)
    disp = ref.displacements(prob.cfg)
    post = ref.Posterior(prob.cfg, prob.quats, prob.voluang, prob.images[prob.check_images],
                         device, precision="tf32")
    n_img = prob.images.shape[0]
    outs = []
    for m, model in enumerate(prob.models):
        r = post.run(model)
        lp, const = np.full(n_img, np.nan), np.full(n_img, np.nan)
        best = np.zeros((n_img, 4), np.int64)
        lp[prob.check_images] = r["log_prob"]
        const[prob.check_images] = r["best_lp"]
        o, c, ix, iy = r["best"].T
        best[prob.check_images] = np.stack([o, c, -disp[ix], -disp[iy]], 1)
        outs.append((m, lp, best, const))
    return outs


def program_reading(cell, seed: int, passes: int, device) -> dict:
    import torch

    from benchmark import problem as problem_mod

    t0 = time.perf_counter()
    prob = problem_mod.build(cell.cfg, cell.mix, seed)
    run = harness.Run(cell, prob)
    session = load_module("drivers", cell.mix["driver"]).start(prob, cell.mix, device, run)
    for _ in range(max(passes, len(prob.models))):
        session.one_pass()
    outputs = session.outputs
    session.close()
    del session
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    judged = harness.judge(prob, outputs, device)
    return {"numbers": judged["numbers"], "pass_s": run.pass_s, "first_pass_s": run.first_pass_s,
            "engine_build_s": run.engine_build_s, "program_s": t1 - t0,
            "check_s": time.perf_counter() - t1}


def control_reading(cell, seed: int, device) -> dict:
    from benchmark import problem as problem_mod

    prob = problem_mod.build(cell.cfg, cell.mix, seed)
    t0 = time.perf_counter()
    judged = harness.judge(prob, control_outputs(prob, device), device)
    return {"numbers": judged["numbers"], "check_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(cache_env())
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    try:
        for kind, seed_list, fn in (("program", seeds, lambda s: program_reading(cell, s, args.passes, device)),
                                    ("control", controls, lambda s: control_reading(cell, s, device))):
            for seed in seed_list:
                line = json.dumps(harness.finite({"workload": args.workload, "kind": kind, "seed": seed,
                                                  "card": torch.cuda.get_device_name(device), **fn(seed)}))
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
