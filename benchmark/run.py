"""One run of one benchmark cell on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's inputs are made from ``--seed``;
set-up runs through the program's own entry points; the window drives
passes back to back for ``--seconds``; with ``--trace 1`` a traced segment
follows. The outputs of every pass are then judged against the plain
reference. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
its limit); the numbers compared are also the last lines of standard
error. Without a CUDA card, or with JAX or the JAX package loaded once the
window has closed, the run prints no result and exits nonzero.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cache_env() -> dict:
    """The program's caches at fixed paths inside the checkout, so that only
    a checkout's first run builds: its kernel library is built into its own
    ``_build/`` there, and the tuner's cache goes under ``benchmark/_cache/``."""
    return {"BIOEM_TPU_AUTOTUNE_CACHE": os.path.join(HERE, "_cache", "autotune.json")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(cache_env())

    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(bench, args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}, which the program may not use",
              file=sys.stderr)
        return 4
    res = out["result"]
    run = out["run"]
    print(f"benchmark: {args.workload} seed {args.seed}: {len(run.pass_s)} passes in "
          f"{run.window_s:.3f} s, set-up {run.setup_s:.3f} s (the benchmark's inputs "
          f"{run.inputs_s:.3f} s of it), peak card memory "
          f"{res['device']['memory_peak_bytes']} bytes", file=sys.stderr)
    for name, value, limit in out["rows"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.finite(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
