"""The frozen counts, the trace arithmetic and the readers, against values
worked by hand."""

import math

import numpy as np
import pytest

from benchmark import counts, harness
from benchmark.registry import load_module


def test_compare_work_by_hand():
    # one comparison of N = 4, F = 3, D = 2, M = 2, fold 2, one (o, c)
    w = counts.compare_work(1, 1, 1, 4, 3, 2, 2, 2)
    assert w["stage1"] == 8 * 2 * 2 * 3
    assert w["rest"] == 6 * 4 * 3 + (6 * 4 * 3 + 2 * 1 * 2 * 3 + 4 * 4 * 3 + 8 * 4)
    assert counts.compare_bytes(1, 1, 1, 4, 3, 2, 2) == 4 * (2 * 3 * 12 + 8 + 12 + 2 + 4)


def test_bound_takes_the_larger_side():
    assert counts.bound({"f32": 67e12}, 0) == pytest.approx(1.0)
    assert counts.bound({"f32": 1}, 3.35e12) == pytest.approx(1.0)
    assert counts.bound({"tf32": 495e12, "f64": 67e12}, 0) == pytest.approx(2.0)


def test_production_pass_bound_matches_the_repo_table():
    # PERF.md §6: K1's bound 0.0762 ms per production block (O = 8, C = 8,
    # I = 64), K2's 0.0052; 544 blocks a pass
    per_block = counts.compare_bound(8, 8, 64, 224, 113, 21, 112, 2)
    assert per_block == pytest.approx(0.0762e-3, rel=2e-3)
    whole = counts.compare_bound(4352, 8, 64, 224, 113, 21, 112, 2)
    assert whole == pytest.approx(544 * per_block, rel=1e-3)
    k2 = counts.projection_bound(8, 224, 113, 500, 14)
    assert 0.0052e-3 < k2 < 0.0060e-3


def test_pass_shapes_of_the_reference_grid():
    from benchmark.problem import Problem, PointModel, orientations

    cfg = harness.load_json(harness.os.path.join(harness.HERE, "configs", "refgrid224.json"))
    q, vol = orientations(cfg["orientations"])
    radii = np.repeat(np.arange(14, dtype=np.float32) + 2, 36)[:500]
    prob = Problem(cfg, q, vol, [PointModel(np.zeros((500, 3), np.float32), radii, radii, 1.0)],
                   np.zeros((64, 224, 224), np.float32), np.arange(16))
    s = counts.pass_shapes(prob)
    assert s == dict(o=4608, c=32, i=64, n=224, f=113, d=81, m=224, fold=1, p=500, g=14)
    b = counts.pass_bounds(prob)
    assert b["pass"] == pytest.approx(b["compare"] + b["projection"] + b["glue"])
    # PERF.md §6: K1's bound 2.4044 ms per reference-grid block of 8 orientations
    assert b["compare"] == pytest.approx(576 * 2.4044e-3, rel=1e-3)
    assert b["compare"] < b["pass"] < 1.01 * b["compare"]


def _trace():
    # window 0..100 µs; ops overlap at 10-30 and 25-40, one at 60-70, one
    # spills past the window's end
    ops = [("k1", 10.0, 30.0), ("k2", 25.0, 40.0), ("Memcpy HtoD", 60.0, 70.0), ("k1", 95.0, 120.0)]
    spans = [("run", 0.0, 45.0), ("results", 45.0, 80.0), ("swap_model", 80.0, 100.0)]
    return harness.Trace(ops, [o for o in ops if not o[0].startswith("Memcpy")], spans,
                         (0.0, 100.0), 2)


def test_trace_busy_and_idle_by_hand():
    t = _trace()
    assert t.busy_intervals() == [(10.0, 40.0), (60.0, 70.0), (95.0, 100.0)]
    assert t.busy_s == pytest.approx(45e-6)
    gaps = dict((round(s * 1e6), label) for label, s in t.idle_gaps())
    assert gaps == {10: "run", 20: "results", 25: "swap_model"}
    bd = harness.breakdown(t)
    assert bd["device_ops"][0] == ["k1", pytest.approx(45e-6)]
    assert [g[0] for g in bd["idle_gaps"]] == ["swap_model", "results", "run"]


def test_device_readers_by_hand():
    run = harness.Run(cell=None, problem=None, trace=_trace())
    assert load_module("metrics", "idle_pct").read(run) == pytest.approx(55.0)
    assert load_module("metrics", "kernels_per_pass").read(run) == pytest.approx(3 / 2)
    assert load_module("metrics", "glue_ms_per_pass").read(run) == pytest.approx(60e-3 / 2)
    assert load_module("metrics", "projection_ms_per_pass").read(run) is None
    assert load_module("metrics", "compare_roofline").read(run) is None


def test_host_readers_by_hand():
    run = harness.Run(cell=None, problem=None, setup_s=7.5, first_pass_s=1.0,
                      pass_s=[0.1 * k for k in range(1, 11)], swap_s=[0.002, 0.004, 0.003],
                      window_s=2.0, comparisons=1000)
    read = lambda name: load_module("metrics", name).read(run)  # noqa: E731
    assert read("comparisons_per_s") == 500.0
    assert read("setup_s") == 7.5
    assert read("swap_model_ms") == pytest.approx(3.0)
    assert read("capture_s") == pytest.approx(0.45)
    assert read("engine_build_s") is None


def test_kernel_layers_by_name():
    from benchmark.kernels import layer_of

    assert layer_of("void compare_fused_kernel<64, 2, 0>(Params)") == "compare"
    assert layer_of("compare_batched_kernel") == "compare"
    assert layer_of("project_kernel") == "projection"
    assert layer_of("project_prologue_kernel") == "projection"
    assert layer_of("void regular_fft<256u>(...)") == "projection"
    assert layer_of("block_constants_kernel") == "glue"
    assert layer_of("void at::native::index_elementwise_kernel") == "glue"


def test_finite_keeps_the_line_json():
    out = harness.finite({"a": math.inf, "b": [1.0, math.nan], "c": {"d": 2.0}})
    assert out == {"a": None, "b": [1.0, None], "c": {"d": 2.0}}
