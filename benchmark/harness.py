"""The general machinery of a benchmark run, driven by the files it names.

``BENCHMARK.json`` names a cell's configuration, its traffic mix and its
metrics; this module finds each by that name and runs the cell:

* ``configs/<config>.json``: the configuration (sizes, grids, model,
  precision); its ``reference`` key names the plain reference in
  ``references/``;
* ``mixes/<traffic>.json``: the traffic (images, models, the check's
  sample, the traced seconds); its ``driver`` key names the module in
  ``drivers/`` that sets the program up and runs one pass;
* ``metrics/<metric>.py``: one reader per metric, ``read(run)`` → a number
  or None (nothing to read: the metric is left out of the line);
* ``limits/<workload>.json``: each number the check compares, with its
  limit.

A later cell, mix or metric is a new file of these folders; nothing here
changes for it. :func:`run_cell` does one run on any device, so the tests
drive it on the CPU; ``run.py`` is the command, which insists on the card.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .registry import HERE, load_json, load_module, reference
# Loaded modules that a run may not hold once its window has closed,
# compared by the whole top-level name (the program's own package name
# begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bioem_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return load_module("metrics", name)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything its names lead to."""

    workload: dict
    cfg: dict
    mix: dict
    limits: dict
    metrics: list  # the BENCHMARK.json entries this cell reports, both kinds


def find_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of a parsed ``BENCHMARK.json``, with its files."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(os.path.join(os.path.dirname(HERE), conf["file"]))
    mix = load_json(os.path.join(HERE, "mixes", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in bench[kind] if name in m.get("workloads", [name])]
    return Cell(w, cfg, mix, limits, metrics)


# ---------------------------------------------------------------------------
# The record a run builds and the metric readers read
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """A traced window: device operations and kernels as (name, start µs,
    end µs), the harness's host spans as (label, start µs, end µs), the
    window's start and end (µs, one clock), and the whole passes run in it."""

    ops: list
    kernels: list
    spans: list
    window: tuple
    passes: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        w0, w1 = self.window
        out = []
        for _n, a, b in sorted(self.ops, key=lambda r: r[1]):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """[(label, seconds)] of every stretch of the window with no device
        operation, labelled by the host span that overlaps it most."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy_intervals() for x in iv] + [w1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            label, most = "outside the harness's spans", 0.0
            for name, s0, s1 in self.spans:
                ov = min(b, s1) - max(a, s0)
                if ov > most:
                    label, most = name, ov
            gaps.append((label, (b - a) * 1e-6))
        return gaps


@dataclass
class Run:
    """What a run measured; the metric readers read it. ``comparisons`` is
    counted from the problem's shapes (counts.pass_shapes), never from the
    program, so the program's blocking or padding cannot move it."""

    cell: Cell
    problem: object
    setup_s: float = 0.0
    inputs_s: float = 0.0
    engine_build_s: float = 0.0
    first_pass_s: float = 0.0
    pass_s: list = field(default_factory=list)
    swap_s: list = field(default_factory=list)
    window_s: float = 0.0
    comparisons: int = 0
    trace: Optional[Trace] = None


# ---------------------------------------------------------------------------
# The traced segment
# ---------------------------------------------------------------------------

SPAN_PREFIX = "bench."


def _is_device_op(e) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith((SPAN_PREFIX, "bioem.")))


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def traced(session, seconds: float, sync) -> Trace:
    """Passes of ``session`` under ``torch.profiler`` for at least
    ``seconds`` (one pass at least), read into a :class:`Trace`."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync()
    passes = 0
    with profile(activities=acts) as prof:
        with record_function(SPAN_PREFIX + "window"):
            t0 = time.perf_counter()
            while passes == 0 or time.perf_counter() - t0 < seconds:
                session.one_pass()
                passes += 1
            sync()
    from torch.autograd import DeviceType

    window, ops, spans = None, [], []
    for e in prof.events():
        if _is_device_op(e):
            ops.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX):
            if e.name == SPAN_PREFIX + "window":
                window = (e.time_range.start, e.time_range.end)
            else:
                spans.append((e.name[len(SPAN_PREFIX):], e.time_range.start, e.time_range.end))
    kernels = [r for r in ops if _is_kernel(r[0])]
    return Trace(ops, kernels, spans, window, passes)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, by name, and the ten
    longest idle gaps, by what the host was doing."""
    per = {}
    for name, a, b in trace.ops:
        per[name] = per.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_gaps(), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def judge(problem, outputs: list, device) -> dict:
    """The numbers that decide ``correct``, from the outputs of every pass:
    ``outputs`` holds, per pass, (model index, log_prob (I,), best (I, 4)
    as orientation, CTF, x and y displacement as the program reports them,
    the best log-probability (I,), the program's ``constoadd``). The plain
    reference judges each checked image of each pass: ``logp_gap`` is the
    widest |log P − the reference's|; ``argmax_lp_gap`` the widest gap
    between the best log-probability the program reports and the
    reference's log-probability at the tuple the program reports for it (a
    tuple off the maximum, or a value off the tuple, shows). Also returns
    the worst of each per pass."""
    refmod = reference(problem.cfg)
    idx = problem.check_images
    disp = refmod.displacements(problem.cfg)
    pos = {int(v): k for k, v in enumerate(disp)}
    n_o, n_c = problem.quats.shape[0], refmod.ctf_grid(problem.cfg).amp.shape[0]

    def query(k, best_row):
        o, c, cx, cy = (int(v) for v in best_row)
        # the program reports the displacement negated (bioem.cpp)
        ix, iy = pos.get(-cx), pos.get(-cy)
        ok = 0 <= o < n_o and 0 <= c < n_c and ix is not None and iy is not None
        return (k, o, c, ix, iy) if ok else None

    post = refmod.Posterior(problem.cfg, problem.quats, problem.voluang, problem.images[idx], device)
    per_model = {}
    for m in sorted({out[0] for out in outputs}):
        qs = {query(k, out[2][i]) for out in outputs if out[0] == m for k, i in enumerate(idx)}
        queries = np.asarray(sorted(q for q in qs if q is not None), np.int64).reshape(-1, 5)
        ref = post.run(problem.models[m], queries)
        per_model[m] = (ref, {q: v for q, v in zip(map(tuple, queries.tolist()), ref["query_lp"])})
    del post
    numbers = {"logp_gap": 0.0, "argmax_lp_gap": 0.0}
    per_pass = []
    for m, lp, best, const in outputs:
        ref, at = per_model[m]
        worst = dict.fromkeys(numbers, 0.0)
        for k, i in enumerate(idx):
            gaps = {"logp_gap": abs(float(lp[i]) - float(ref["log_prob"][k])),
                    "argmax_lp_gap": abs(float(const[i]) - float(at.get(query(k, best[i]), math.nan)))}
            for key, g in gaps.items():
                worst[key] = max(worst[key], g if math.isfinite(g) else math.inf)
        per_pass.append(worst)
        for key in numbers:
            numbers[key] = max(numbers[key], worst[key])
    return {"numbers": numbers, "per_pass": per_pass}


def verdict(judged: dict, limits: dict) -> tuple:
    """(correct, failed passes, [(name, value, limit)]) against a cell's
    limits; a number that is not finite, or has no limit, fails."""
    rows = [(k, v, limits.get(k)) for k, v in judged["numbers"].items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _k, v, lim in rows)
    failed = sum(1 for p in judged["per_pass"]
                 if any(not (math.isfinite(v) and v <= limits.get(k, -1)) for k, v in p.items()))
    return ok and failed == 0, failed, rows


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def device_sync(device):
    import torch

    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell``: its inputs from ``seed``, set-up through the
    driver, a closed loop of passes for ``seconds``, with ``trace`` a
    traced segment after it, then the check and the metrics. ``t_start``
    is the perf_counter reading at process start (set-up counts from it).
    Returns the result's fields, the check's rows and the run record."""
    import torch

    from . import problem as problem_mod
    from .counts import pass_shapes

    sync = device_sync(device)
    t_inputs = time.perf_counter()
    prob = problem_mod.build(cell.cfg, cell.mix, seed)
    driver = load_module("drivers", cell.mix["driver"])
    run = Run(cell, prob, inputs_s=time.perf_counter() - t_inputs)
    shapes = pass_shapes(prob)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.zeros(1, device=device)  # the allocator starts with the first tensor
        torch.cuda.reset_peak_memory_stats(device)
    session = driver.start(prob, cell.mix, device, run)
    sync()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    while not run.pass_s or time.perf_counter() - t0 < seconds:
        session.one_pass()
    run.window_s = time.perf_counter() - t0
    run.comparisons = len(run.pass_s) * shapes["o"] * shapes["c"] * shapes["i"]
    if trace:
        run.trace = traced(session, cell.mix["trace_seconds"], sync)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    outputs = session.outputs
    attempted = len(outputs)
    session.close()
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    judged = judge(prob, outputs, device)
    correct, failed, rows = verdict(judged, cell.limits)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"result": out, "rows": rows, "run": run}


def finite(obj):
    """``obj`` with every float that is not finite replaced by None, so the
    line stays JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj
