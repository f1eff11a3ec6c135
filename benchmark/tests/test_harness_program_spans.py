"""The readers of the program's spans: each reads its number from a
recorder seeded with known spans, and reads nothing (None) where the
program has no recorder or the recorder holds no such span."""

import pytest

from benchmark.registry import load_module

from bioem_tpu_torch.utils import timestat

READERS = {
    # metric: (span, its parent, seconds seeded in order, the number read)
    "library_load_s": ("bioem.library", "bioem.capture.warmup", [0.25, 0.5], 0.25),
    "capture_graph_s": ("bioem.capture.graph", "bioem.capture", [1.5, 0.1], 1.5),
    "swap_bounds_ms": ("bioem.swap_model.bounds", "bioem.swap_model", [0.004, 0.001, 0.002], 2.0),
    "swap_layout_ms": ("bioem.swap_model.layout", "bioem.swap_model", [0.02, 0.01, 0.03, 0.05], 25.0),
    "swap_pin_ms": ("bioem.place.pin", "bioem.swap_model", [0.003, 0.009, 0.006], 6.0),
}


@pytest.fixture
def recorder(monkeypatch):
    rec = timestat.TimeStat()
    monkeypatch.setattr(timestat, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_its_span(recorder, metric):
    name, parent, seconds, want = READERS[metric]
    for s in seconds:
        recorder.add(name, s, parent=parent)
    assert load_module("metrics", metric).read(None) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_without_the_span(recorder, metric):
    recorder.add("bioem.pass", 1.0)
    assert load_module("metrics", metric).read(None) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_nothing_without_a_recorder(monkeypatch, metric):
    monkeypatch.delattr(timestat, "RECORDER")
    assert load_module("metrics", metric).read(None) is None


def test_pin_reads_only_the_model_swap(recorder):
    """Page-locking under an image swap or the engine's set-up is not the
    model swap's."""
    recorder.add("bioem.place.pin", 0.5, parent="bioem.swap_images")
    assert load_module("metrics", "swap_pin_ms").read(None) is None
    recorder.add("bioem.place.pin", 0.002, parent="bioem.swap_model")
    assert load_module("metrics", "swap_pin_ms").read(None) == pytest.approx(2.0)
