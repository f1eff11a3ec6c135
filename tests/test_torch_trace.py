"""The port's spans and counters (bioem_tpu_torch/utils/timestat.py): the
recorder's nesting, self time, shared root ids, per-thread stacks and
bounded memory; the spans in a torch.profiler trace; and the spans a tiny
CPU engine, a swap and the CLI record."""

import os
import re
import statistics
import sys
import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core.engine import BioEMEngine
from bioem_tpu_torch.core.orientations import build_orientations
from bioem_tpu_torch.rank import common_model_layout
from bioem_tpu_torch.utils.timestat import KEEP, RECORDER, TimeStat

from .conftest import tiny_images, tiny_model, tiny_params

PKG = os.path.join(os.path.dirname(__file__), "..", "bioem_tpu_torch")


def _busy(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_with_parents_self_time_and_one_root():
    rec = TimeStat()
    with rec.span("bioem.t.outer"):
        _busy(0.002)
        with rec.span("bioem.t.inner"):
            _busy(0.002)
        with rec.span("bioem.t.inner"):
            with rec.span("bioem.t.leaf"):
                _busy(0.001)
    with rec.span("bioem.t.outer"):
        pass
    (o1, o2), inner, (leaf,) = (rec.records("bioem.t.outer"), rec.records("bioem.t.inner"),
                                rec.records("bioem.t.leaf"))
    assert o1.parent is None and o2.parent is None and o1.root != o2.root
    assert [r.parent for r in inner] == ["bioem.t.outer"] * 2 and leaf.parent == "bioem.t.inner"
    assert {r.root for r in (*inner, leaf)} == {o1.root}
    assert o1.start_ns <= inner[0].start_ns < inner[0].end_ns <= inner[1].start_ns
    assert leaf.end_ns <= inner[1].end_ns <= o1.end_ns
    assert rec.count("bioem.t.inner") == 2 and rec.count("bioem.t.outer") == 2
    covered = sum(r.end_ns - r.start_ns for r in inner)
    assert rec.self_seconds("bioem.t.outer") == pytest.approx(
        (o1.end_ns - o1.start_ns - covered + o2.end_ns - o2.start_ns) * 1e-9, abs=1e-12)
    assert rec.self_seconds("bioem.t.inner") == pytest.approx(
        (covered - (leaf.end_ns - leaf.start_ns)) * 1e-9, abs=1e-12)
    assert rec.self_seconds("bioem.t.outer") >= 0.0015
    assert rec.durations("bioem.t.inner", parent="bioem.t.outer") == [r.seconds for r in inner]
    assert rec.durations("bioem.t.inner", parent="bioem.t.leaf") == []
    rec.add_count("bioem.t.things")
    rec.add_count("bioem.t.things", 4)
    assert rec.count("bioem.t.things") == 5 and rec.count("bioem.t.absent") == 0
    assert rec.names() == ["bioem.t.outer", "bioem.t.inner", "bioem.t.leaf", "bioem.t.things"]


def test_a_span_records_when_its_body_raises():
    rec = TimeStat()
    with pytest.raises(ValueError):
        with rec.span("bioem.t.outer"):
            with rec.span("bioem.t.inner"):
                raise ValueError("boom")
    assert rec.count("bioem.t.inner") == 1 and rec.count("bioem.t.outer") == 1
    with rec.span("bioem.t.after"):
        pass
    assert rec.records("bioem.t.after")[0].parent is None  # the stack unwound


def test_each_thread_nests_its_own_spans():
    rec = TimeStat()
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with rec.span(f"bioem.t.{tag}"):
            both_open.wait()
            with rec.span("bioem.t.child"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    (a,), (b,) = rec.records("bioem.t.a"), rec.records("bioem.t.b")
    children = rec.records("bioem.t.child")
    assert a.root != b.root
    assert sorted((c.parent, c.root) for c in children) == [("bioem.t.a", a.root),
                                                             ("bioem.t.b", b.root)]


def test_recording_from_many_threads_loses_no_update():
    """More threads than cores, a short switch interval: every span and
    count arrives, and self times add up to the top-level spans' time."""
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 400
    rec = TimeStat(keep=n_threads * n_spans)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with rec.span("bioem.t.top"):
                    with rec.span("bioem.t.mid"):
                        rec.add_count("bioem.t.n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_spans
    assert rec.count("bioem.t.top") == rec.count("bioem.t.mid") == rec.count("bioem.t.n") == total
    assert {r.parent for r in rec.records("bioem.t.mid")} == {"bioem.t.top"}
    top = rec.records("bioem.t.top")
    assert len({r.root for r in top}) == len(top)
    assert rec.self_seconds("bioem.t.top") + rec.self_seconds("bioem.t.mid") == pytest.approx(
        sum(rec.durations("bioem.t.top")), abs=1e-9)


def test_memory_is_bounded_after_1e5_spans():
    rec = TimeStat()
    tracemalloc.start()
    try:
        for _ in range(20_000):
            with rec.span("bioem.t.outer"):
                with rec.span("bioem.t.inner"):
                    pass
        early = tracemalloc.get_traced_memory()[0]
        for _ in range(80_000):
            with rec.span("bioem.t.outer"):
                with rec.span("bioem.t.inner"):
                    pass
        late = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert late - early < 64 * 1024, (early, late)
    recs = rec.records("bioem.t.inner")
    assert rec.count("bioem.t.inner") == 100_000 and len(recs) == KEEP + 1
    first = recs[0]
    assert first.root == rec.records("bioem.t.outer")[0].root == 1  # the first is kept
    assert all(a.start_ns < b.start_ns for a, b in zip(recs, recs[1:]))
    assert len(rec.durations("bioem.t.outer")) == KEEP + 1


def test_seeded_spans_read_back():
    """``add`` records a span of known length (the benchmark's readers'
    tests seed a recorder so); the first is kept past ``keep``."""
    rec = TimeStat(keep=3)
    for s in (5.0, 1.0, 2.0, 3.0, 4.0):
        rec.add("bioem.t.x", s, parent="bioem.t.p")
    assert rec.durations("bioem.t.x") == pytest.approx([5.0, 2.0, 3.0, 4.0])
    assert rec.durations("bioem.t.x", parent="bioem.t.p") == pytest.approx([5.0, 2.0, 3.0, 4.0])
    assert rec.durations("bioem.t.x", parent="bioem.t.q") == []
    assert rec.self_seconds("bioem.t.x") == pytest.approx(15.0)


def test_timestat_table_has_count_total_mean_sigma_self():
    rec = TimeStat()
    rec.add("bioem.t.x", 1.0)
    rec.add("bioem.t.x", 3.0)
    rec.add_count("bioem.t.builds")
    table = rec.summary()
    row = next(line for line in table.splitlines() if "bioem.t.x" in line)
    nums = [float(v) for v in re.findall(r"(\d+\.\d+)s", row)]
    assert nums == pytest.approx([4.0, 2.0, 1.0, 4.0]) and "(n=2)" in row
    assert re.search(r"bioem\.t\.builds\s+count 1", table)


# ---------------------------------------------------------------------------
# spans in a torch.profiler trace
# ---------------------------------------------------------------------------

def test_spans_land_in_a_profiler_trace_with_their_nesting():
    rec = TimeStat()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("bioem.t.outer"):
            _busy(0.003)
            with rec.span("bioem.t.inner"):
                torch.ones(64).sum()
                _busy(0.002)
    events = {e.name: e for e in prof.events() if e.name.startswith("bioem.t.")}
    assert set(events) == {"bioem.t.outer", "bioem.t.inner"}
    outer, inner = events["bioem.t.outer"].time_range, events["bioem.t.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    for name, e in events.items():
        ours = rec.durations(name)[0] * 1e6
        theirs = e.time_range.end - e.time_range.start
        assert abs(theirs - ours) <= max(0.1 * ours, 50.0), (name, ours, theirs)
    # without a profiler no range is opened, and the span still records
    with rec.span("bioem.t.outer"):
        pass
    assert rec.count("bioem.t.outer") == 2


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def _delta(before, names):
    return {n: RECORDER.count(n) - before[n] for n in names}


def test_engine_records_its_spans_on_the_cpu(rng):
    names = ["bioem.engine", "bioem.engine.images", "bioem.engine.model",
             "bioem.engine.banks", "bioem.pass", "bioem.results", "bioem.projection",
             "bioem.swap_model", "bioem.swap_model.bounds", "bioem.swap_model.layout",
             "bioem.swap_images", "bioem.swap_images.layout", "bioem.place.pin",
             "bioem.place.copy", "bioem.library", "bioem.library.builds", "bioem.capture",
             "bioem.graph_load"]
    before = {n: RECORDER.count(n) for n in names}
    p = tiny_params()
    models = [tiny_model(rng, n_points=10), tiny_model(rng, n_points=7)]
    images = tiny_images(rng, 2, p.n_pixels)
    cfg = RunConfig(orient_block=2)
    eng = BioEMEngine(p, build_orientations(p), models[0], images, cfg, device="cpu",
                      model_layout=common_model_layout(p, models, cfg.projection))
    nblk = eng.ang_blocks.shape[0]
    assert _delta(before, names) == dict.fromkeys(names, 0) | {
        "bioem.engine": 1, "bioem.engine.images": 1, "bioem.engine.model": 1,
        "bioem.engine.banks": 1}
    eng.results(eng.run())
    banks = eng.swap_model(models[1])
    eng.results(eng.run(banks=banks))
    eng.swap_images(images.maps[::-1].copy())
    assert _delta(before, names) == dict.fromkeys(names, 0) | {
        "bioem.engine": 1, "bioem.engine.images": 1, "bioem.engine.model": 1,
        "bioem.engine.banks": 1, "bioem.pass": 2, "bioem.results": 2,
        "bioem.projection": 2 * nblk, "bioem.swap_model": 1, "bioem.swap_model.bounds": 1,
        "bioem.swap_model.layout": 1, "bioem.swap_images": 1, "bioem.swap_images.layout": 1,
        "bioem.place.pin": 2, "bioem.place.copy": 2}
    last = {n: RECORDER.records(n)[-1] for n in ("bioem.swap_model.bounds",
                                                 "bioem.place.pin", "bioem.place.copy")}
    assert last["bioem.swap_model.bounds"].parent == "bioem.swap_model"
    assert last["bioem.place.pin"].parent == last["bioem.place.copy"].parent == "bioem.swap_images"
    assert len(RECORDER.durations("bioem.place.pin", parent="bioem.swap_model")) >= 1
    assert RECORDER.records("bioem.projection")[-1].parent == "bioem.pass"
    assert RECORDER.records("bioem.engine.model")[-1].root == RECORDER.records("bioem.engine")[-1].root
    assert all(n.startswith("bioem.") for n in RECORDER.names()), RECORDER.names()


def test_the_program_names_every_span_and_counter_bioem():
    """Every span and counter the package opens has a literal name under
    ``bioem.``: tools reading a trace drop the program's ranges by it."""
    pattern = re.compile(r"(?<![.\w])(?:span|count)\(\s*f?([\"'])(.*?)\1")
    found = []
    for base, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(base, f), encoding="utf-8").read()
                found += [m.group(2) for m in pattern.finditer(src)]
    assert len(found) >= 20
    assert [n for n in found if not n.startswith("bioem.")] == []


def test_run_bioem_reads_autotune_seconds_from_its_span(rng):
    from bioem_tpu_torch.run import run_bioem

    p = tiny_params()
    _res, perf = run_bioem(p, build_orientations(p), tiny_model(rng), tiny_images(rng, 2, p.n_pixels),
                           RunConfig(orient_block=2, autotune=False), device="cpu")
    assert perf["autotune_s"] == RECORDER.durations("bioem.autotune")[-1] > 0


@pytest.mark.parametrize("debug", ["0", "1"])
def test_cli_prints_the_table_at_debug_output_1(tmp_path, monkeypatch, capsys, debug):
    from .test_torch_golden import run_port_cli

    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    monkeypatch.setenv("BIOEM_DEBUG_OUTPUT", debug)
    run_port_cli("case_a_euler_ctf", tmp_path)
    out = capsys.readouterr().out
    if debug == "0":
        assert "Time statistics" not in out
        return
    table = out.split("Time statistics:")[1]
    for name in ("bioem.autotune", "bioem.engine", "bioem.pass", "bioem.results"):
        assert re.search(rf"{re.escape(name)}\s+total .* self .*\(n=\d+\)", table), name


def test_swap_parts_sum_to_the_swap(rng):
    """The swap's four parts cover it: what the swap span holds beyond
    them is the span bookkeeping alone."""
    p = tiny_params()
    models = [tiny_model(rng, n_points=10), tiny_model(rng, n_points=7)]
    cfg = RunConfig(orient_block=2)
    eng = BioEMEngine(p, build_orientations(p), models[0], tiny_images(rng, 2, p.n_pixels), cfg,
                      device="cpu", model_layout=common_model_layout(p, models, cfg.projection))
    for _ in range(5):
        eng.swap_model(models[1])
    gaps = []
    for swap in RECORDER.records("bioem.swap_model")[-5:]:
        parts = [r for n in ("bioem.swap_model.bounds", "bioem.swap_model.layout",
                             "bioem.place.pin", "bioem.place.copy")
                 for r in RECORDER.records(n, parent="bioem.swap_model") if r.root == swap.root]
        assert len(parts) == 4
        covered = sum(r.seconds for r in parts)
        assert covered <= swap.seconds
        gaps.append((swap.seconds - covered) / swap.seconds)
    assert statistics.median(gaps) < 0.1, gaps
