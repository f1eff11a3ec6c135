"""The port's accuracy, scale and profiling tools (``bioem_tpu_torch.tools``)
against the JAX package's on the same inputs, on the CPU.

* The port's all-f64 oracle equals ``tests/oracle/oracle.run_oracle``
  (rtol 1e-12) on three golden cases.
* The port's error budget on its plain branch holds the JAX suite's limits
  (``tests/test_golden.py``, ``test_engine_beats_reference_precision``:
  engine–oracle below 2e-5 at N = 64 and 5e-6 at N = 224, and below
  oracle–golden / 50), and its three gaps lie within 1e-7 of the JAX
  tool's (the engine–oracle gap within 1e-6 at N = 224, where the two
  engines' f32 paths differ by 4.7e-7 in logP). Every configuration (the
  kernels' plain versions here) holds the absolute limits on the
  normalised maps too.
* scale_bench, stream_50k, rank_bench and mesh_scale_bench at tiny sizes
  keep their JSON keys, and their logP equals the port's run_bioem,
  run_streaming or rank_models on the same problem bit for bit, and the
  JAX package's at the suite's rtol 1e-9 / atol 1e-7 (on noise images:
  see SMALL).
* profile_block, trace_step, pipeline_lab and accuracy_probe run on the
  CPU and return their rows; noise_recovery_table's grid seed equals the
  JAX tool's.

The entry points take the card unless asked for the CPU, so these pass
``device="cpu"`` or set BIOEM_TPU_FORCE_CPU=1.
"""

import os
import sys

import numpy as np
import pytest
import torch

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.rank import rank_models as j_rank_models
from bioem_tpu.run import run_bioem as j_run_bioem
from bioem_tpu.stream import ArraySource as JArraySource
from bioem_tpu.stream import run_streaming as j_run_streaming
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.rank import rank_models
from bioem_tpu_torch.run import run_bioem
from bioem_tpu_torch.stream import ArraySource, run_streaming
from bioem_tpu_torch.tools import (accuracy_probe, golden_error_budget, mesh_scale_bench,
                                   noise_recovery_table, oracle, pipeline_lab, problem,
                                   profile_block, rank_bench, scale_bench, stream_50k,
                                   trace_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.oracle.oracle import run_oracle as j_run_oracle  # noqa: E402
from tools import golden_error_budget as j_budget  # noqa: E402

SUITE = dict(rtol=1e-9, atol=1e-7)
# tests/test_golden.py:146-165
ORACLE_ATOL = {"case_l_n64": 2e-5, "case_n_n224": 5e-6}
# The port's gaps against the JAX tool's. At N = 224 the two engines' f32
# paths differ by ~4.7e-7 in logP (7e-12 of |logP|), which moves the
# engine–oracle gap by as much; the golden gaps agree to 1e-7 at both N.
GAP_ATOL = {"case_l_n64": (1e-7, 1e-7), "case_n_n224": (1e-7, 1e-6)}
# A small production problem: the production model and CTFs at N = 32, the
# images pure noise (signal 0). The suite's port-vs-JAX tolerance holds on
# noise images, as in every other port test (measured 6 % of it here); with
# the planted signal at 0.3 the two f32 paths' cc rounding, amplified by
# a_coef = (3 − N²)/2 on a large u, moves logP by ~4e-9 of |logP|, 19× the
# tolerance. The oracle tests above hold each engine to f64 truth instead.
SMALL = dict(n_pix=32, max_disp=4, signal=0.0)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")


@pytest.mark.parametrize("case", ["case_a_euler_ctf", "case_l_n64", "case_n_n224"])
def test_oracle_equals_jax_oracle(case):
    """The port's oracle is the JAX package's arithmetic on the port's host
    layer: every output equal at rtol 1e-12 on the same case files."""
    case_dir = os.path.join(golden_error_budget.DATA, case)
    p, orients, model, images = golden_error_budget.load_case(case_dir)
    pj, oj, mj, ij = j_budget.load_case(case_dir)
    args = lambda m: (m.points.astype(np.float64), m.radii.astype(np.float64),  # noqa: E731
                      m.densities.astype(np.float64), m.norm_den)
    got = oracle.run_oracle(p, orients, *args(model), images.maps)
    ref = j_run_oracle(pj, oj, *args(mj), ij.maps)
    for field in ("log_prob", "constoadd", "total", "max_norm", "max_mu"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field), rtol=1e-12,
                                   err_msg=field)
    for field in ("max_orient", "max_conv", "max_cent_x", "max_cent_y"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)


@pytest.mark.parametrize("case", sorted(ORACLE_ATOL))
def test_budget_holds_jax_limits_and_equals_jax_budget(case, capsys):
    """The plain branch's engine–oracle gap holds the JAX test's absolute
    and /50 limits, and the three gaps lie within 1e-7 of the JAX tool's
    (whose engine runs the XLA path on the CPU)."""
    b = golden_error_budget.budget(case, RunConfig(use_kernels=False), device="cpu")
    assert b.comparison == "plain" and b.n == (64 if case == "case_l_n64" else 224)
    assert b.eng_orc < ORACLE_ATOL[case]
    assert b.eng_orc < b.orc_gold / 50
    _n, eng_gold, orc_gold, eng_orc = j_budget.budget(case)
    gold_atol, oracle_atol = GAP_ATOL[case]
    np.testing.assert_allclose([b.eng_gold, b.orc_gold], [eng_gold, orc_gold], rtol=0,
                               atol=gold_atol)
    assert abs(b.eng_orc - eng_orc) <= oracle_atol


@pytest.mark.parametrize("config", ["plain", "K1", "K4", "hybrid"])
def test_budget_normalized_every_configuration(config):
    """On case L's maps normalised as the MRC ingest does, the f32 gate
    opens and each configuration runs its comparison (on the CPU, its
    kernels' plain versions), held to the JAX absolute limit; on the
    case's own maps the kernel configurations take the hybrid."""
    cfg = {"plain": RunConfig(use_kernels=False), "K1": RunConfig(use_kernels=True),
           "K4": RunConfig(use_kernels=True, fused_batched=True),
           "hybrid": RunConfig(use_kernels=True, fused_lse=False)}[config]
    b = golden_error_budget.budget("case_l_n64", cfg, device="cpu", normalized=True)
    assert b.comparison == config
    assert np.isnan(b.eng_gold) and np.isnan(b.orc_gold)
    assert b.eng_orc < ORACLE_ATOL["case_l_n64"]
    raw = golden_error_budget.budget("case_l_n64", cfg, device="cpu")
    assert raw.comparison == ("plain" if config == "plain" else "hybrid")


def test_accuracy_probe_rows():
    rows = accuracy_probe.probe("case_l_n64", configs=("plain", "K1"))
    assert [r["config"] for r in rows] == ["plain", "K1"]
    plain, k1 = rows
    assert plain["ran"] == "plain" and k1["ran"] == "hybrid" and k1["ran_normalized"] == "K1"
    assert plain["engine_vs_plain"] == 0.0 and plain["engine_vs_plain_normalized"] == 0.0
    for r in rows:
        assert r["cli_vs_f32_golden"] <= 1e-2 and r["cli_vs_f64_golden"] <= 2e-3
        assert max(r["engine_vs_oracle"], r["engine_vs_oracle_normalized"]) < 2e-5


def test_production_problem_is_bench_shape():
    """The production problem has bench.py's widths, orientations and
    model radii and densities (the same seed-0 draws)."""
    import bench

    p, orients, model, images, planted = problem.build_problem(n_img=2)
    pj, oj, mj, _ = bench.build_problem()
    for f in ("n_pixels", "pixel_size", "max_displace_center", "grid_space_center"):
        assert getattr(p, f) == getattr(pj, f)
    assert p.n_ctf == pj.n_ctf == 8 and orients.n == oj.n == 4352
    np.testing.assert_array_equal(model.radii, mj.radii)
    np.testing.assert_array_equal(model.densities, mj.densities)
    assert images.maps.shape == (2, 224, 224) and len(planted["orient"]) == 2
    w = problem.compare_work(8, 8, 64, 224, 113, 21, 112, 2)
    assert problem.compare_bound(8, 8, 64, 224, 113, 21, 112, 2, tensor_cores=True)[1] == \
        "operations" and w["stage1"] == 8 * 21 * 112 * 113 * 8 * 8 * 64


def _j_config(**kw):
    return JConfig(autotune=False, **kw)


@pytest.mark.parametrize("write_angles", [0, 30])
def test_scale_bench_equals_run_bioem_and_jax(write_angles):
    rec = scale_bench.run_one(40, write_angles, device="cpu", n_img=3, **SMALL)
    line = scale_bench.json_line(rec)
    for key in ("n_orient", "write_prob_angles", "comparisons", "seconds", "comparisons_per_s",
                "peak_card_mb", "logp_finite", "device"):
        assert f'"{key}"' in line
    assert rec["logp_finite"] and rec["comparisons"] == 40 * 8 * 3
    p, orients, model, images, _ = problem.build_problem(n_orient=40, n_img=3, **SMALL)
    p.write_angles = write_angles
    own, _ = run_bioem(p, orients, model, images, RunConfig(autotune=False), device="cpu")
    assert rec["log_prob"].tobytes() == own.log_prob.tobytes()
    ref, _ = j_run_bioem(p, orients, model, images, _j_config())
    np.testing.assert_allclose(rec["log_prob"], ref.log_prob, **SUITE)


def test_stream_50k_equals_run_streaming_and_jax():
    rec, res = stream_50k.stream(20, 8, n_orient=24, device="cpu", **SMALL)
    for key in ("n_images", "mesh", "n_orient", "n_ctf", "chunk_images", "comparisons",
                "device_s", "wall_s", "comparisons_per_s_device_loop", "captures",
                "peak_card_mb"):
        assert key in rec
    assert rec["chunks"] == 3 and rec["captures"] == 0 and rec["comparisons"] == 20 * 24 * 8
    src = stream_50k.SyntheticSource(20, 32)
    maps = np.concatenate([src.chunk(s, min(s + 8, 20)) for s in range(0, 20, 8)])
    np.testing.assert_array_equal(src.chunk(8, 16), src.chunk(8, 16))  # seeded by start
    p, orients, model, _, _ = problem.build_problem(n_orient=24, n_img=1, **SMALL)
    own, _ = run_streaming(p, orients, model, ArraySource(maps), RunConfig(autotune=False),
                           chunk_images=8, device="cpu")
    assert res.log_prob.tobytes() == own.log_prob.tobytes()
    ref, _ = j_run_streaming(p, orients, model, JArraySource(maps), _j_config(), chunk_images=8)
    np.testing.assert_allclose(res.log_prob, ref.log_prob, **SUITE)


def test_rank_bench_equals_rank_models_and_jax():
    rec, log_probs = rank_bench.bench(3, 3, 24, device="cpu", **SMALL)
    for key in ("n_models", "n_images", "n_orient", "cold_s", "mean_swap_run_s",
                "reuse_total_s", "naive_estimate_s", "speedup_vs_naive",
                "comparisons_per_s_reuse", "captures"):
        assert key in rec
    p, orients, model0, images, _ = problem.build_problem(n_orient=24, n_img=3, **SMALL)
    models = rank_bench.candidates(model0, 3)
    _total, per_image, _ = rank_models(p, orients, models, images, RunConfig(autotune=False),
                                       device="cpu")
    for m in range(3):
        assert log_probs[m].tobytes() == per_image[m].tobytes()
    _tj, per_image_j, _ = j_rank_models(p, orients, models, images, _j_config())
    np.testing.assert_allclose(np.stack(log_probs), per_image_j, **SUITE)


def test_mesh_scale_bench_rows_agree():
    rows, logps = mesh_scale_bench.ladder(2, 24, 4, device="cpu", **SMALL)
    assert [r["mesh"] for r in rows] == [[1, 1], [1, 2]]
    for r in rows:
        for key in ("n_slots", "comparisons_per_s", "comparisons_per_s_per_slot", "run_s",
                    "merge_s", "scaling_efficiency_pct", "logp_max_abs_diff_vs_1slot"):
            assert key in r
    assert rows[1]["logp_max_abs_diff_vs_1slot"] <= 1e-6 * max(1.0, np.abs(logps[0]).max())
    assert mesh_scale_bench.mesh_shapes(8) == [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4)]
    p, orients, model, images, _ = problem.build_problem(n_orient=24, n_img=4, **SMALL)
    own, _ = run_bioem(p, orients, model, images, RunConfig(autotune=False), device="cpu")
    assert logps[0].tobytes() == own.log_prob.tobytes()
    ref, _ = j_run_bioem(p, orients, model, images, _j_config())
    np.testing.assert_allclose(logps[0], ref.log_prob, **SUITE)


@pytest.fixture(scope="module")
def small_problem():
    return problem.build_problem(n_img=4, quat_grid=3, **SMALL)


def test_profile_block_rows(small_problem):
    out = profile_block.profile(profile_block.engine_for(small_problem, device="cpu"), reps=2)
    assert set(out["phases"]) == {"step", "projection", "constants", "compare", "merge",
                                  "residual"}
    assert out["compare"]["kernel"] == "K1" and out["timer"] == "host clock (CPU)"
    o, c, i, n, f, d, m = 8, 8, 4, 32, 17, 5, 16
    assert out["compare"]["operations"] == sum(problem.compare_work(o, c, i, n, f, d, m, 2).values())


def test_trace_step_rows(small_problem):
    out = trace_step.trace(profile_block.engine_for(small_problem, device="cpu"), n_blocks=2)
    assert out["device"] == "cpu" and not out["replayed"] and out["rows"]
    assert abs(out["rows_total_ms"] - out["profiler_total_ms"]) <= 1e-6 * out["profiler_total_ms"]
    phases = {ph for ph, _op, _n, _us in out["by_op"]}
    assert {"bioem.projection", "bioem.constants", "bioem.compare", "bioem.max_repair",
            "bioem.merge"} <= phases


def test_pipeline_lab_rows(small_problem):
    eng = profile_block.engine_for(small_problem, device="cpu")
    out = pipeline_lab.lab(eng, reps=1)
    assert set(out) == {"fused", "batched", "hybrid"}
    assert all(r["host_ms"] > 0 for r in out.values())
    steps = pipeline_lab.steps(eng)
    fused, hybrid = steps["fused"](), steps["hybrid"]()
    for a, b in zip(fused[2:], hybrid[2:]):  # argmax, cc at it, K
        np.testing.assert_allclose(a.numpy(), b.reshape(a.shape).numpy(), rtol=1e-5)


def test_noise_recovery_seed_equals_jax(monkeypatch):
    """Level 0, trial 0: the port's planted trial reaches JAX's grid seed
    (the JAX tool is stopped before its refinement); the port's table runs
    its refinement (cut to 2 starts × 4 iterations here)."""
    import bioem_tpu.refine as j_refine
    from tools import noise_recovery_table as j_table

    class Seed(Exception):
        pass

    def stop(eng, res, **kw):
        raise Seed(res)

    monkeypatch.setattr(j_refine, "refine_results", stop)
    with pytest.raises(Seed) as seen:
        j_table.one_trial(0.0, 0)
    res_j = seen.value.args[0]
    _eng, res, _truth = noise_recovery_table.plant(0.0, 0, device="cpu")
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(res, f), np.asarray(getattr(res_j, f)), err_msg=f)
    np.testing.assert_allclose(res.log_prob, np.asarray(res_j.log_prob), rtol=1e-6)

    import bioem_tpu_torch.refine as t_refine

    full = t_refine.refine_results
    monkeypatch.setattr(t_refine, "refine_results",
                        lambda *a, **kw: full(*a, **kw, n_starts=2, iters=4))
    torch.set_num_threads(1)
    rows = noise_recovery_table.table(1, levels=(0.0,), device="cpu")
    assert len(rows) == 1 and rows[0]["ang_refined_median"] <= rows[0]["ang_seed_median"] + 1e-6
    assert "| 0.0 |" in noise_recovery_table.markdown(rows)
