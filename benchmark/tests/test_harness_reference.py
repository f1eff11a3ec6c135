"""The plain reference against the program's CPU path, on a problem the CPU
holds, and its frozen inputs against the program's own builders. (The
reference imports nothing of the program; these tests do, to compare.)"""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import harness, problem
from benchmark.registry import reference

REF = reference({"reference": "bioem_posterior"})


def test_reference_imports_nothing_of_the_program():
    for path in (REF.__file__, problem.__file__):
        tree = ast.parse(open(path).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"jax", "jaxlib", "flax", "bioem_tpu", "bioem_tpu_torch"}, (path, tops)


def test_frozen_orientations_equal_the_programs():
    from bioem_tpu_torch.utils.so3 import super_fibonacci

    q, vol = problem.orientations({"kind": "super_fibonacci", "n": 4608})
    np.testing.assert_array_equal(q, super_fibonacci(4608).astype(np.float32))
    assert vol == 1 / 4608


def test_frozen_ctf_bank_and_constants_equal_the_programs():
    from benchmark import port
    from bioem_tpu_torch.core.ctf import build_ctf_bank
    from bioem_tpu_torch.params import (displacement_lists, log_normalization_constant,
                                        make_ctf_grid, orientation_volume_quirked)

    cfg = harness.load_json(os.path.join(harness.HERE, "configs", "refgrid224.json"))
    p = port.params(cfg)
    grid = REF.ctf_grid(cfg)
    theirs = make_ctf_grid(p)
    np.testing.assert_array_equal(grid.phase, theirs.phase)
    np.testing.assert_array_equal(grid.env, theirs.env)
    np.testing.assert_array_equal(REF.ctf_bank(cfg, grid), build_ctf_bank(p, theirs).real)
    np.testing.assert_array_equal(REF.displacements(cfg), displacement_lists(p)[0])
    vol = 1 / 4608
    k = log_normalization_constant(p, orientation_volume_quirked(p, vol, theirs))
    assert REF.log_norm_constant(cfg, grid, vol) == pytest.approx(k, rel=1e-12)


def test_projection_equals_the_programs_plain_fourier_projection(cell_of):
    from benchmark import port
    from bioem_tpu_torch.core.orientations import rotation_matrices
    from bioem_tpu_torch.core.projection import make_fourier_projection_spec, project_fourier_batch

    cell = cell_of("refgrid224.set64", n=64)
    prob = problem.build(cell.cfg, cell.mix, 7)
    p = port.params(cell.cfg)
    m = prob.models[0]
    spec, gidx, pmask, st, sums = make_fourier_projection_spec(p, m.radii)
    q = torch.as_tensor(prob.quats[:16])
    t = torch.as_tensor
    pr, pi = project_fourier_batch(spec, rotation_matrices(q, True), t(m.points[gidx]),
                                   t(m.radii[gidx]), t(m.densities[gidx] * pmask),
                                   t(np.float32(m.norm_den)), t(np.ascontiguousarray(st.real)),
                                   t(np.ascontiguousarray(st.imag)), t(sums))
    ours = REF.project(cell.cfg, q, m, "cpu").numpy()
    theirs = pr.double().numpy() + 1j * pi.double().numpy()
    assert np.abs(ours - theirs).max() / np.abs(ours).max() < 1e-5


@pytest.mark.parametrize("name", ["refgrid224.set64", "refgrid224.rank2x20"])
def test_reference_agrees_with_the_programs_cpu_path(cell_of, name):
    """The whole check on the CPU (the program's plain branch): every pass's
    log P, and its best log-probability against the reference's at the
    program's tuple, within 2e-4."""
    cell = cell_of(name)
    out = harness.run_cell(cell, 2 ** 33 + 5, 0.2, False, "cpu", 0.0)
    checks = out["result"]["checks"]
    assert out["result"]["correct"], checks
    assert checks["logp_gap"]["value"] < 2e-4
    assert checks["argmax_lp_gap"]["value"] < 2e-4
    assert out["result"]["attempted"] >= 2


def test_the_same_seed_gives_the_same_inputs_and_seeds_the_same_sizes(cell_of):
    cell = cell_of("refgrid224.rank2x20")
    a, b = problem.build(cell.cfg, cell.mix, -3), problem.build(cell.cfg, cell.mix, -3)
    c = problem.build(cell.cfg, cell.mix, 2 ** 40 + 1)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.models[1].points, b.models[1].points)
    assert a.images.shape == c.images.shape and len(a.models) == len(c.models)
    assert not np.array_equal(a.images, c.images)
    assert [np.unique(m.radii).size for m in a.models] == [np.unique(a.models[0].radii).size] * 2
