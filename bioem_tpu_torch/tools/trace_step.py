"""Device-time breakdown of the block loop by kernel, and of its glue by the
torch op that launched it.

The port's counterpart of the JAX package's ``tools/trace_step.py``. It runs
``torch.profiler`` (CPU and CUDA activities) over ``n_blocks`` blocks of the
production problem (``tools/problem.py``) as the pass runs them (replays of
the captured block step on the card) and prints:

* every device kernel at ≥ 1 % of the window's device time, by name, with
  its launches and µs per block, then one ``other`` row (its kernel count
  and time) for the rest; the rows' sum beside the device time that
  ``key_averages()`` reports, and the card's busy share of the window
  (device time over the window's CUDA-event time);
* the glue (every kernel but the comparison and projection kernels,
  K1–K4's ``compare_*`` and K2's ``project_kernel``) grouped by the block
  step's phase (the ``bioem.*`` ``record_function`` ranges of
  ``core/engine.py``: projection, constants, compare, merge)
  and the outermost torch op that launched it, then per phase with the
  glue's own kernels (G1, G2, G3, G4) added by name. A graph replay carries no
  launching op, so this grouping profiles the same blocks as the eager
  loop of block steps (the same kernels, each launched from Python).

If the profiler shows no device time for the replays, the rows fall back
to ``profile_block``'s CUDA-event phases, and the output says so. On the
CPU (``BIOEM_TPU_FORCE_CPU=1``, a caller's small problem) the "kernels" are
the torch ops' self CPU times of the eager loop, and the output says so.

    python -m bioem_tpu_torch.tools.trace_step [n_blocks] [--projection raster]
                                                            (default 8 blocks)
"""

from __future__ import annotations

import collections
import sys
import time

import torch

# Kernel-name stems of the hand-written kernels (K1/K3: compare_fused_*,
# K4: compare_batched_*, K2: project_kernel); everything else is glue.
KERNEL_STEMS = ("compare_fused", "compare_batched", "project_kernel")
# The glue's own hand-written kernels (ops/posterior_cuda.py: G1, G2;
# ops/project_cuda.py: G3, G4) and the phase that launches each: they are
# launched through ctypes, not by a torch op, so by_op does not see them and
# glue_by_phase adds them by name.
GLUE_KERNELS = (("block_constants_kernel", "bioem.constants"),
                ("merge_block_kernel", "bioem.merge"),
                ("project_prologue_kernel", "bioem.projection"),
                ("raster_projection_kernel", "bioem.projection"))


def _device_us(e) -> float:
    return getattr(e, "device_time_total", None) or e.cuda_time_total


def device_kernels(events) -> list:
    """The card's kernels among profiler ``events`` (``prof.events()`` or
    ``key_averages()``): the CUDA-type events other than the card-side
    spans of ``record_function`` ranges (such as the engine's ``bioem.*``
    phases), which would count their kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("bioem.")]


def _phase(ev) -> str:
    """The block step's phase range (``bioem.*``, core/engine.py) that
    profiler event ``ev`` ran under."""
    q = ev.cpu_parent
    while q is not None:
        if q.name.startswith("bioem."):
            return q.name
        q = q.cpu_parent
    return "(outside the block step's phases)"


def _outer_op(ev):
    """The outermost torch op enclosing op ``ev`` (itself if none)."""
    while ev.cpu_parent is not None and ev.cpu_parent.name.startswith("aten::"):
        ev = ev.cpu_parent
    return ev


def by_op(prof, n_blocks: int, on_card: bool) -> list:
    """[(phase, torch op, kernels per block, µs per block)] of the glue,
    largest first: on the card each kernel counted under the outermost op
    that launched it; on the CPU each op's self CPU time."""
    acc = collections.defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if not ev.name.startswith("aten::"):
            continue
        if on_card:
            kern = [k for k in ev.kernels if not any(s in k.name for s in KERNEL_STEMS)]
            if not kern:
                continue
            n, us = len(kern), sum(k.duration for k in kern)
        else:
            n, us = 1, ev.self_cpu_time_total
        outer = _outer_op(ev)
        a = acc[(_phase(outer), outer.name)]
        a[0] += n
        a[1] += us
    rows = [(f, op, n / n_blocks, us / n_blocks) for (f, op), (n, us) in acc.items()]
    return sorted(rows, key=lambda r: -r[3])


def glue_by_phase(prof, n_blocks: int) -> dict:
    """{phase: [kernels per block, µs per block]} of the glue of a profile
    of eager blocks on the card: :func:`by_op`'s rows summed per phase,
    and the glue kernels (:data:`GLUE_KERNELS`) under the phases that launch
    them."""
    acc = collections.defaultdict(lambda: [0.0, 0.0])
    for phase, _op, n, us in by_op(prof, n_blocks, True):
        acc[phase][0] += n
        acc[phase][1] += us
    for e in device_kernels(prof.events()):
        for stem, phase in GLUE_KERNELS:
            if stem in e.name:
                acc[phase][0] += 1 / n_blocks
                acc[phase][1] += e.time_range.elapsed_us() / n_blocks
    return dict(acc)


def trace(eng, n_blocks: int = 8) -> dict:
    """Profile ``n_blocks`` blocks of ``eng`` (from block 0, after two
    warm-up replays or one eager warm-up pass) as its pass runs them; see
    the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    dev = eng.device
    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    n_blocks = min(n_blocks, eng.ang_blocks.shape[0])
    replayed = eng._replayed()
    bk = eng.banks

    def eager(state):
        for b in range(n_blocks):
            eng._block_step(state, bk, eng.ang_blocks[b], b * eng.o_block, eng.mask_blocks[b])

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if replayed:
        state = eng._graph_load(eng.initial_state(), 0)
        for _ in range(2):
            eng._replay()

        def window():
            eng._graph_load(state, 0)
            for _ in range(n_blocks):
                eng._replay()
    else:
        eager(eng.initial_state())  # warm-up

        def window():
            eager(eng.initial_state())
    sync()
    with profile(activities=acts) as prof:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            window()
            stop.record()
        else:
            t0 = time.perf_counter()
            window()
        sync()
    window_ms = start.elapsed_time(stop) if on_card else (time.perf_counter() - t0) * 1e3
    if on_card:
        total_us = sum(_device_us(e) for e in device_kernels(prof.key_averages()))
        per_name = collections.defaultdict(lambda: [0, 0.0])
        for e in device_kernels(prof.events()):
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us()
    else:
        ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
        total_us = sum(e.self_cpu_time_total for e in ops)
        per_name = {e.key: [e.count, e.self_cpu_time_total] for e in ops}
    out = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "n_blocks": n_blocks, "replayed": replayed, "window_ms": window_ms,
           "profiler_total_ms": total_us * 1e-3, "fallback": None}
    rows, other = [], [0, 0.0]
    for name, (n, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        if us >= 0.01 * total_us:
            rows.append((name, n / n_blocks, us / n_blocks))
        else:
            other[0] += n
            other[1] += us
    out["rows"] = rows
    out["other"] = (other[0] / n_blocks, other[1] / n_blocks)
    out["rows_total_ms"] = (sum(r[2] for r in rows) + out["other"][1]) * n_blocks * 1e-3
    out["busy_share"] = out["profiler_total_ms"] / window_ms if on_card else None
    if on_card and total_us == 0:
        from .profile_block import profile as phases

        out["fallback"] = ("torch.profiler shows no device time for the replays: CUDA-event "
                           "phases of one block (profile_block) instead")
        out["rows"] = [(k, 1, v * 1e3) for k, v in phases(eng)["phases"].items()]
    with profile(activities=acts) as prof_eager:
        eager(eng.initial_state())
        sync()
    out["by_op"] = by_op(prof_eager, n_blocks, on_card)
    out["by_phase"] = glue_by_phase(prof_eager, n_blocks) if on_card else None
    return out


def report(out: dict, say=print) -> None:
    nb = out["n_blocks"]
    what = ("replayed blocks" if out["replayed"] else "eager blocks")
    if out["device"] == "cpu":
        say(f"{nb} {what} on the CPU: the rows are torch ops' self CPU time (no device kernels)")
    else:
        say(f"{nb} {what} on {out['device']}: window {out['window_ms']:.3f} ms (CUDA events), "
            f"device time {out['profiler_total_ms']:.3f} ms (key_averages), busy "
            f"{100 * out['busy_share']:.1f} %")
    if out["fallback"]:
        say(out["fallback"])
    say(f"{'kernel':<70} {'per block':>9} {'us/block':>10}")
    for name, n, us in out["rows"]:
        say(f"{name[:70]:<70} {n:9.1f} {us:10.2f}")
    say(f"{'other':<70} {out['other'][0]:9.1f} {out['other'][1]:10.2f}")
    say(f"rows + other: {out['rows_total_ms']:.3f} ms against {out['profiler_total_ms']:.3f} ms")
    say("glue by block-step phase and launching torch op (eager blocks, same kernels):")
    say(f"{'phase':<20} {'op':<28} {'kernels/block':>13} {'us/block':>10}")
    for phase, op, n, us in out["by_op"]:
        say(f"{phase[:20]:<20} {op[:28]:<28} {n:13.1f} {us:10.2f}")
    if out["by_phase"]:
        say("glue by phase, the glue kernels (G1–G4) included: " + "; ".join(
            f"{ph} {n:.1f} kernels {us:.1f} us" for ph, (n, us) in sorted(out["by_phase"].items())))


def main(argv=None) -> int:
    from .profile_block import engine_for, parse_args

    n_blocks, projection = parse_args(sys.argv[1:] if argv is None else argv, "n_blocks", 8)
    report(trace(engine_for(projection=projection), n_blocks=n_blocks),
           say=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
