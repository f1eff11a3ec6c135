"""The reference's production grid (tools/problem.REFERENCE_GRID: 4608
quaternions × 32 CTFs × 81×81 displacements at stride 1) on the CPU.

* The port's plain branch against the JAX engine at N = 96, D = 81, all 32
  CTFs, 2 noise images and two orientation blocks, at the suite's
  tolerance (noise images: see tests/test_torch_bench.py's C2 note).
* K1's tiling at that grid: ``k1_plan(81, 224, 113, 1)`` is two
  warpgroups (one 88-row chunk) and K chunks of eight steps, four at fold
  2 (stage 2's tiles over the chunk buffers),
  the production block's D = 21 keeps its plan, and the lattices the
  earlier kernel refused at N = 224 (D ≥ 107 at fold 1, D ≥ 105 at fold 2)
  are tiled.
* A lattice wider than that: the port's engine against the JAX engine at
  N = 128, D = 121 (±60 at stride 1), on the plain branch and on the
  kernel branch (whose wrappers run their plain versions on the CPU).
* The grid's parameter file and the files ``write_reference_grid`` writes
  read back through the port's readers as the problem in memory, and the
  CLI's output on them (at N = 96 and 8 orientations) parses back to its
  argmax, the planted orientation among it.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.run import make_engine as j_make_engine
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.ops.compare_cuda import k1_plan
from bioem_tpu_torch.params import displacement_lists, make_ctf_grid, read_parameters
from bioem_tpu_torch.run import make_engine
from bioem_tpu_torch.tools import golden_error_budget, problem

SUITE = dict(rtol=1e-9, atol=1e-7)
ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")
# N = 96 holds the ±40 lattice; 16 orientations are two blocks of 8.
GRID96 = {**problem.REFERENCE_GRID, "n_orient": 16, "n_pix": 96}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")


def test_plain_branch_matches_jax_at_d81():
    p, orients, model, images, _ = problem.build_problem(n_img=2, signal=0.0, **GRID96)
    assert (p.nx_disp, p.grid_space_center, make_ctf_grid(p).n) == (81, 1, 32)
    eng = make_engine(p, orients, model, images, RunConfig(autotune=False, orient_block=8),
                      device="cpu")
    assert eng.ang_blocks.shape[0] == 2 and eng.n_fold == 1
    got = eng.results(eng.run())
    ej = j_make_engine(p, orients, model, images, JConfig(autotune=False, orient_block=8))
    want = ej.results(ej.run())
    np.testing.assert_allclose(got.log_prob, want.log_prob, **SUITE)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_k1_plan_at_the_reference_grid():
    # two warpgroups, each taking the whole lattice (one chunk of 88 rows;
    # W holds t1_re's 88 rows), and K chunks of eight steps: W hi/lo 2 ×
    # 45,056, conv 2 × 17,408 (fold 1), and over them stage 2's t1 tiles
    # (2 × 2 × 64 × 96 floats, 98,304); one half of stage 2's B (hi and
    # lo, 88 rows × 64 frequencies: 45,056); the two lattices 57,088; at
    # fold 2 the conv rows double and K chunks of four fit (the t1 tiles
    # then the larger)
    assert k1_plan(81, 224, 113, 1) == (2, 8, 227072)
    assert k1_plan(81, 112, 113, 2) == (2, 4, 200448)
    # the production grid's D = 21 keeps four warpgroups and K chunks of 8
    assert k1_plan(21, 112, 113, 2)[:2] == (4, 8)
    # the lattices the earlier kernel refused at N = 224 (from D = 107 at
    # fold 1, 105 at fold 2) are tiled, ±60 at stride 1 on two warpgroups in
    # two chunks of 64 rows (stage 2's B 128 lattice columns wide: 65,536
    # a half, hi and lo)
    assert k1_plan(107, 224, 113, 1) is not None and k1_plan(105, 112, 113, 2) is not None
    assert k1_plan(121, 224, 113, 1) == (2, 8, 227840)


# N = 128 holds ±60 at stride 1 (D = 121), which the earlier K1 refused at
# every N; 4 CTFs keep the JAX side's CPU time small.
WIDE128 = dict(n_orient=16, n_pix=128, max_disp=60, disp_step=1, n_phase=2, n_env=2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_matches_jax_at_d121(use_kernels):
    p, orients, model, images, _ = problem.build_problem(n_img=2, signal=0.0, **WIDE128)
    assert (p.nx_disp, p.grid_space_center, p.n_pixels) == (121, 1, 128)
    cfg = RunConfig(autotune=False, orient_block=8, use_kernels=use_kernels)
    eng = make_engine(p, orients, model, images, cfg, device="cpu")
    assert eng.ang_blocks.shape[0] == 2 and eng.n_fold == 1 and eng.disp.shape[0] == 121
    got = eng.results(eng.run())
    ej = j_make_engine(p, orients, model, images, JConfig(autotune=False, orient_block=8))
    want = ej.results(ej.run())
    np.testing.assert_allclose(got.log_prob, want.log_prob, **SUITE)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_reference_grid_params_file(tmp_path):
    path = tmp_path / "param.txt"
    path.write_text(problem.reference_grid_params())
    got = read_parameters(str(path), not_uniform_angles=True)
    want = problem.build_problem(n_img=1, **problem.REFERENCE_GRID)[0]
    assert (got.n_pixels, got.pixel_size, got.nx_disp) == (224, 1.06, 81)
    gg, gw = make_ctf_grid(got), make_ctf_grid(want)
    assert gg.n == gw.n == 32
    for f in ("amp", "phase", "env"):
        np.testing.assert_allclose(getattr(gg, f), getattr(gw, f), rtol=1e-12, err_msg=f)
    for a, b in zip(displacement_lists(got), displacement_lists(want)):
        np.testing.assert_array_equal(a, b)


def test_written_grid_reads_back_and_the_cli_recovers(tmp_path):
    """write_reference_grid's files read back as the problem (maps to f32
    rounding after the MRC reader's normalisation, orientations and points
    to the text's 6 decimals); the CLI on them writes finite logP, and its
    Maximizing Param rows parse back (golden_error_budget.parse_maximizing)
    to run_bioem's argmax on the same files, the planted orientation."""
    from bioem_tpu_torch.cli import main as cli_main
    from bioem_tpu_torch.core.orientations import build_orientations
    from bioem_tpu_torch.io.map_io import ImageStack, read_mrc_maps
    from bioem_tpu_torch.io.model_io import read_model
    from bioem_tpu_torch.run import run_bioem

    prob = problem.orientation_cut(
        problem.build_problem(n_img=2, **{**GRID96, "n_orient": 64}), 4)
    p, orients, model, images, planted = prob
    argv = problem.write_reference_grid(str(tmp_path), prob)
    pr = read_parameters(str(tmp_path / "param.txt"), not_uniform_angles=True)
    back = build_orientations(pr, str(tmp_path / "quat.txt"))
    np.testing.assert_allclose(back.angles, orients.angles, atol=5e-7)
    maps = read_mrc_maps(str(tmp_path / "particles.mrc"), p.n_pixels).maps
    np.testing.assert_allclose(maps, images.maps, atol=1e-5)
    m = read_model(str(tmp_path / "model.txt"), pixel_size=pr.pixel_size)
    np.testing.assert_allclose(m.points, model.points, atol=1e-5)

    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli_main([*argv, "--OutputFile", "out"]) == 0
    finally:
        os.chdir(old)
    lp = golden_error_budget.parse_golden(str(tmp_path / "out"))
    best = golden_error_budget.parse_maximizing(str(tmp_path / "out"))
    assert lp.shape == (2,) and np.isfinite(lp).all()
    # the rows are the CLI's argmax: run_bioem on the files read back
    res, _ = run_bioem(pr, back, m, ImageStack(maps), RunConfig(autotune=False), device="cpu")
    np.testing.assert_allclose(best[:, 0], res.log_prob, atol=1e-4)
    np.testing.assert_allclose(best[:, 1:5], back.angles[res.best_orient], atol=1e-4)
    grid = make_ctf_grid(pr)
    defocus = grid.phase / 2.0 / np.pi / pr.electron_wavelength * 1e-4
    np.testing.assert_allclose(best[:, 6], defocus[res.best_conv], atol=1e-4)
    np.testing.assert_allclose(best[:, 7], grid.env[res.best_conv], atol=1e-4)
    np.testing.assert_array_equal(best[:, 8:10], np.stack([res.best_cent_x, res.best_cent_y], 1))
    # and the planted orientation is recovered (q and −q one rotation)
    q = orients.angles[planted["orient"]].astype(np.float64)
    dots = np.abs(np.sum(best[:, 1:5] * q, axis=1)) / np.linalg.norm(best[:, 1:5], axis=1)
    assert (dots > 1 - 1e-4).all()
