"""A density map as the model (``--ReadModelMRC``) on the CPU: the port's
plain branch on a small voxel map against the benchmark's plain reference
of a map (benchmark/references/bioem_voxel_map.py), its TF32 control
refused by the same tolerance, the path rule (core.projection
.choose_projection), the out-of-frame census (core.projection.oob_census)
against projection_oob_report, BioEM's voxel coordinates through a written
and read MRC file, and the spans and counters the map's set-up records;
and the port against the JAX package on the same map: its MRC reader, its
engine's log P on each projection path, its census.

The small problem is the benchmark cell ``map224.mapset20`` cut to N = 32:
a 32³ map of 40 residues, 64 orientations, 4 CTFs, D = 5, 4 images."""

import ast
import copy
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, port, problem  # noqa: E402
from benchmark.registry import load_module, reference  # noqa: E402
from bioem_tpu_torch.config import RunConfig  # noqa: E402
from bioem_tpu_torch.core.orientations import rotation_matrices  # noqa: E402
from bioem_tpu_torch.core.projection import (  # noqa: E402
    choose_projection,
    oob_census,
    projection_oob_report,
)
from bioem_tpu_torch.io.model_io import Model, read_model  # noqa: E402
from bioem_tpu_torch.run import make_engine  # noqa: E402
from bioem_tpu_torch.utils.timestat import RECORDER  # noqa: E402

# The program's plain branch reads 1.5e-5 to 4.4e-5 from the f64 reference
# on this problem, the TF32 control 2.0e-2 to 2.8e-2.
TOL = 1e-3
SEED = 2 ** 33 + 17


def _small_cell():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = copy.deepcopy(harness.find_cell(bench, "map224.mapset20"))
    cfg = cell.cfg
    cfg.update(n_pixels=32, max_displace_center=2)
    cfg["orientations"] = {"kind": "super_fibonacci", "n": 64, "count": 64}
    cfg["ctf"].update(n_defocus=2, n_bfactor=2)
    cfg["model"].update(n_points=40, radius_A=10.0)
    cfg["map"]["box"] = 32
    cell.mix.update(n_images=4, check_images=4)
    return cell


def _read_map(cfg, prob) -> Model:
    """The configuration's map of the problem's model, written as an MRC
    file by the benchmark's driver and read by the program's reader."""
    drv = load_module("drivers", "map_repeat_pass")
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "map.mrc")
        drv.write_mrc(path, reference(cfg).voxel_map(cfg, prob.models[0]), cfg["pixel_size"])
        return read_model(path, read_mrc=True, pixel_size=cfg["pixel_size"])


def _small_problem():
    cell = _small_cell()
    prob = problem.build(cell.cfg, cell.mix, SEED)
    p, orients, _residues, images = port.inputs(prob)
    return dict(cell=cell, prob=prob, p=p, orients=orients, images=images,
                model=_read_map(cell.cfg, prob))


@pytest.fixture(scope="module")
def small():
    return _small_problem()


def _judged(small, outputs):
    return harness.judge(small["prob"], outputs, "cpu")["numbers"]


@pytest.mark.parametrize("projection", ["auto", "raster"])
def test_voxel_map_cpu_path_agrees_with_the_reference(small, projection):
    """The plain branch (the path rule's choice, and the raster forced) on
    the map read from its MRC file, judged by the benchmark's check against
    the f64 reference of the map: log P and the best log-probability within
    TOL."""
    eng = make_engine(small["p"], small["orients"], small["model"], small["images"],
                      RunConfig(projection=projection), device="cpu")
    assert (eng.fspec is None) == (projection == "raster"
                                   or choose_projection(small["p"], [small["model"]]) == "raster")
    session = port.Session(harness.Run(small["cell"], small["prob"]), "cpu")
    session.eng = eng
    session.scored(0)
    numbers = _judged(small, session.outputs)
    assert numbers["logp_gap"] < TOL and numbers["argmax_lp_gap"] < TOL, numbers


def test_tf32_control_fails_the_same_tolerance(small):
    """The reference computed with its cross-correlation in TF32, put in the
    program's place, is refused by the tolerance the program passes."""
    from benchmark.calibrate import control_outputs

    numbers = _judged(small, control_outputs(small["prob"], "cpu"))
    assert numbers["logp_gap"] > TOL and numbers["argmax_lp_gap"] > TOL, numbers


def test_reference_map_is_the_programs_read_model(small):
    """The reference's voxel model (its own coordinates and centring) is the
    program's read of the MRC file, bit for bit: the snaps the check
    compares start from the same floats."""
    vm = reference(small["cell"].cfg).voxel_model(small["cell"].cfg, small["prob"].models[0])
    m = small["model"]
    np.testing.assert_array_equal(vm.points, m.points)
    np.testing.assert_array_equal(vm.densities, m.densities)
    np.testing.assert_array_equal(vm.radii, m.radii)
    assert vm.norm_den == m.norm_den
    assert m.n_points == 32 ** 3 and (m.densities != 0).all()


def test_reference_and_driver_import_nothing_of_jax():
    """The map's reference imports nothing of the program or of JAX; its
    driver nothing of JAX."""
    ref = reference({"reference": "bioem_voxel_map"}).__file__
    drv = load_module("drivers", "map_repeat_pass").__file__
    for path, banned in ((ref, {"jax", "jaxlib", "flax", "bioem_tpu", "bioem_tpu_torch"}),
                         (drv, {"jax", "jaxlib", "flax", "bioem_tpu"})):
        tree = ast.parse(open(path).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not {n.split(".")[0] for n in names} & banned, path


def test_path_rule(small):
    """refgrid224's 500-residue model keeps the Fourier path; a 32³ map and a
    40-radius model take the raster at N = 224; "fourier" and "raster"
    force their paths, and "fourier" refuses more than 32 radii."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    ref_cell = harness.find_cell(bench, "refgrid224.set64")
    ref_prob = problem.build(ref_cell.cfg, dict(ref_cell.mix, n_images=1, check_images=1), 3)
    p224 = port.params(ref_cell.cfg)
    residues = port.inputs(ref_prob)[2][0]
    assert np.unique(residues.radii).size == 14
    cube = small["model"]
    rng = np.random.default_rng(4)
    dens = rng.uniform(40.0, 100.0, 40).astype(np.float32)
    radii40 = Model(rng.uniform(-5, 5, (40, 3)).astype(np.float32),
                    np.linspace(1.0, 3.0, 40).astype(np.float32), dens, float(dens.sum()))
    assert choose_projection(p224, [residues]) == "fourier"
    assert choose_projection(p224, [cube]) == "raster"
    assert choose_projection(p224, [radii40]) == "raster"
    assert choose_projection(p224, [residues, cube]) == "raster"
    assert choose_projection(p224, [cube], "fourier") == "fourier"
    assert choose_projection(p224, [residues], "raster") == "raster"
    with pytest.raises(ValueError, match="requires <= 32 distinct radii"):
        choose_projection(p224, [radii40], "fourier")


def test_census_equals_the_report_on_a_cube_map(small):
    """The census of the 32³ map at N = 32 (its corners leave the frame at
    every orientation) on the CPU, from the orientation rows, is
    projection_oob_report on torch's rotation matrices of the rows; and the
    engine warns with its count."""
    p, m = small["p"], small["model"]
    ang = np.asarray(small["orients"].angles, np.float32)
    rot = rotation_matrices(torch.as_tensor(ang), True).numpy()
    want = projection_oob_report(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y,
                                 m.points, m.radii, rot)
    got = oob_census(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y, m.points, m.radii, ang,
                     True, device="cpu")
    assert want[0] > 0 and want[1] == ang.shape[0]
    assert got == want
    with pytest.warns(RuntimeWarning, match=f"^{got[0]} point projections fall outside"):
        make_engine(p, small["orients"], m, small["images"], RunConfig(), device="cpu")


def test_census_counts_a_map_entirely_out_of_the_frame(small):
    """A map moved far out of the frame: every orientation drops every
    point, and the engine refuses it (tempden would be 0)."""
    p, m = small["p"], small["model"]
    far = Model(m.points + np.float32(200.0), m.radii, m.densities, m.norm_den)
    ang = np.asarray(small["orients"].angles, np.float32)
    total, affected, all_oob = oob_census(p.n_pixels, p.pixel_size, 0, 0, far.points, far.radii,
                                          ang, True)
    assert (total, affected, all_oob) == (ang.shape[0] * m.n_points, ang.shape[0], ang.shape[0])
    with pytest.raises(ValueError, match="entirely outside"):
        make_engine(p, small["orients"], far, small["images"], RunConfig(), device="cpu")


def test_mrc_map_gives_bioem_voxel_coordinates(tmp_path):
    """A written and read mode-2 MRC map of 5 × 6 × 7 voxels: voxel (i, j,
    k), from 1 in file order (i slowest, over the header's nc), at ((i −
    nx/2)·pix, (j − ny/2)·pix, (k − nz/2)·pix), radius 2·pix, its value the
    density; centred on the density mass when asked."""
    from bioem_tpu_torch.io.mrc import write_mrc

    rng = np.random.default_rng(9)
    stack = rng.uniform(0.1, 2.0, (5, 6, 7)).astype(np.float32)  # (ns, nr, nc)
    path = str(tmp_path / "m.mrc")
    write_mrc(path, stack, 1.3)
    m = read_model(path, read_mrc=True, pixel_size=1.3, center_mass=False)
    nx, ny, nz = 7, 6, 5
    i, j, k = (a.ravel() + 1 for a in np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                                  indexing="ij"))
    want = np.stack([(i - nx / 2.0) * 1.3, (j - ny / 2.0) * 1.3, (k - nz / 2.0) * 1.3],
                    1).astype(np.float32)
    np.testing.assert_array_equal(m.points, want)
    np.testing.assert_array_equal(m.densities, stack.reshape(-1))
    np.testing.assert_array_equal(m.radii, np.full(m.n_points, np.float32(2.6)))
    assert m.norm_den == float(stack.astype(np.float64).sum())
    c = read_model(path, read_mrc=True, pixel_size=1.3)
    cm = (m.points * m.densities[:, None]).sum(axis=0) / np.float32(m.norm_den)
    np.testing.assert_array_equal(c.points, (m.points - cm).astype(np.float32))


def test_spans_and_counters_of_a_map_reach_the_table(small):
    """Reading the map and building its engine record ``bioem.model.read``,
    ``bioem.bounds`` (also under ``bioem.swap_model.bounds`` on a swap),
    the path counter of each model laid out and the out-of-frame count, all
    in the CLI's table."""
    cfg = small["cell"].cfg
    before = {n: RECORDER.count(n) for n in ("bioem.projection.raster", "bioem.projection.fourier",
                                             "bioem.bounds.oob_points", "bioem.model.read")}
    model = _read_map(cfg, small["prob"])
    eng = make_engine(small["p"], small["orients"], model, small["images"],
                      RunConfig(projection="raster"), device="cpu")
    eng.swap_model(model)
    assert RECORDER.count("bioem.model.read") == before["bioem.model.read"] + 1
    assert RECORDER.count("bioem.projection.raster") == before["bioem.projection.raster"] + 2
    assert RECORDER.count("bioem.bounds.oob_points") > before["bioem.bounds.oob_points"]
    assert RECORDER.durations("bioem.bounds", parent="bioem.swap_model.bounds")
    table = RECORDER.summary()
    for name in ("bioem.model.read", "bioem.bounds", "bioem.projection.raster",
                 "bioem.bounds.oob_points"):
        assert name in table


def test_driver_stops_unless_the_rule_takes_the_raster(small, monkeypatch):
    """The cell's driver asks the program's path rule first and stops,
    before any engine or pass, where the rule would take the Fourier path
    for the map."""
    import bioem_tpu_torch.core.projection as proj
    import bioem_tpu_torch.run as run_mod

    monkeypatch.setattr(proj, "choose_projection", lambda *a, **k: "fourier")
    monkeypatch.setattr(run_mod, "make_engine",
                        lambda *a, **k: pytest.fail("the driver built an engine"))
    drv = load_module("drivers", "map_repeat_pass")
    run = harness.Run(small["cell"], small["prob"])
    with pytest.raises(RuntimeError, match="takes the fourier projection"):
        drv.start(small["prob"], small["cell"].mix, "cpu", run)
    assert run.pass_s == [] and run.first_pass_s == 0.0


# ---------------------------------------------------------------------------
# The port against the JAX package on the same map
# ---------------------------------------------------------------------------

# log P, the port against the JAX engine on the 32³ map. The JAX suite's
# bound between its own paths (rtol 1e-9 / atol 1e-7, tests/test_torch_engine
# .py) holds for its 12-point model; here each projection sums 32,768
# points in f32 in another order (the JAX package: XLA's scatter and sums;
# the port: index_add_ and torch's matmul), measured max |ΔlogP| 1.39e-5
# (Fourier) and 1.23e-5 (raster) at |logP| ≈ 1437, below either side's own
# gap from the f64 reference (1.5e-5 to 4.4e-5, TOL above). Held, as
# test_torch_engine.py holds its summation-order cases, to 4× the measured
# error.
MAP_VS_JAX = dict(rtol=0, atol=5.6e-5)


def _write_map(cfg, prob, path):
    load_module("drivers", "map_repeat_pass").write_mrc(
        path, reference(cfg).voxel_map(cfg, prob.models[0]), cfg["pixel_size"])


@pytest.mark.parametrize("center_mass", [False, True])
def test_mrc_reader_matches_the_jax_reader(small, tmp_path, center_mass):
    """One MRC file of the 32³ map read by the JAX package's reader and by
    the port's (``--ReadModelMRC``, with and without the density-mass
    centring): points, radii, densities and norm_den equal, bit for bit."""
    from bioem_tpu.io.model_io import read_model as jax_read_model

    cfg = small["cell"].cfg
    path = str(tmp_path / "map.mrc")
    _write_map(cfg, small["prob"], path)
    kw = dict(read_mrc=True, pixel_size=cfg["pixel_size"], center_mass=center_mass)
    want, got = jax_read_model(path, **kw), read_model(path, **kw)
    assert got.n_points == want.n_points == 32 ** 3
    for field in ("points", "radii", "densities"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.norm_den == want.norm_den


def _jax_inputs(small):
    """The small problem in the JAX package's types: the same numbers."""
    import dataclasses

    from bioem_tpu.core.orientations import OrientationSet as JOrients
    from bioem_tpu.io.map_io import ImageStack as JImages
    from bioem_tpu.io.model_io import Model as JModel
    from bioem_tpu.params import BioEMParams as JParams

    p, o, m = small["p"], small["orients"], small["model"]
    jp = JParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})
    return (jp, JOrients(o.angles, o.use_quaternions, o.voluang, o.priors),
            JModel(m.points, m.radii, m.densities, m.norm_den), JImages(small["images"].maps))


@pytest.mark.parametrize("projection", ["fourier", "raster"])
def test_voxel_map_log_p_matches_the_jax_engine(small, projection):
    """The JAX engine and the port's plain branch on the 32³ map read from
    its MRC file, each path forced on both: log P within MAP_VS_JAX, the
    best orientation, CTF and displacement equal."""
    rj = _jax_results(small, projection)
    eng = make_engine(small["p"], small["orients"], small["model"], small["images"],
                      RunConfig(projection=projection), device="cpu")
    assert (eng.fspec is None) == (projection == "raster")
    rt = eng.results(eng.run())
    np.testing.assert_allclose(rt.log_prob, rj.log_prob, **MAP_VS_JAX)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)


def _jax_results(small, projection):
    from bioem_tpu.config import RunConfig as JConfig
    from bioem_tpu.core.engine import BioEMEngine as JEngine

    ej = JEngine(*_jax_inputs(small), JConfig(projection=projection))
    return ej.results(ej.run())


# The 32³ map problem above and the JAX engine's results on it on the
# raster path, stored so that the card's tests (tests/test_torch_cuda.py,
# where JAX is not installed) hold G4's kernel variants to the JAX package.
# Written by ``JAX_PLATFORMS=cpu python tests/test_torch_voxel_map.py``.
MAP32_JAX = os.path.join(ROOT, "tests", "data", "map32_jax_raster.npz")
BEST_FIELDS = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")


def write_map32_jax(path=MAP32_JAX):
    import dataclasses
    import json

    small = _small_problem()
    rj = _jax_results(small, "raster")
    p, o, m = small["p"], small["orients"], small["model"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, params=json.dumps(dataclasses.asdict(p)), angles=o.angles,
        voluang=o.voluang, points=m.points, radii=m.radii, densities=m.densities,
        norm_den=m.norm_den, images=small["images"].maps,
        log_prob=np.asarray(rj.log_prob),
        **{f: np.asarray(getattr(rj, f)) for f in BEST_FIELDS})


def load_map32_jax(path=MAP32_JAX):
    """(params, orientations, model, images) in the port's types and the
    JAX engine's results, {field: array}, from ``MAP32_JAX``."""
    import json

    from bioem_tpu_torch.core.orientations import OrientationSet
    from bioem_tpu_torch.io.map_io import ImageStack
    from bioem_tpu_torch.params import BioEMParams

    z = np.load(path)
    p = BioEMParams(**json.loads(str(z["params"])))
    orients = OrientationSet(z["angles"], True, float(z["voluang"]))
    model = Model(z["points"], z["radii"], z["densities"], float(z["norm_den"]))
    want = {f: z[f] for f in ("log_prob",) + BEST_FIELDS}
    return (p, orients, model, ImageStack(z["images"])), want


def test_stored_map_problem_is_the_small_problem(small):
    """The stored 32³ problem is the one the tests above build: params,
    orientations and the map's points and radii equal, its densities and
    images within f32 rounding (the planting and the map are host f64 math
    whose last bits may follow the CPU's vector unit)."""
    import dataclasses

    (p, o, m, images), want = load_map32_jax()
    assert dataclasses.asdict(p) == dataclasses.asdict(small["p"])
    np.testing.assert_array_equal(o.angles, small["orients"].angles)
    assert o.voluang == small["orients"].voluang
    np.testing.assert_array_equal(m.points, small["model"].points)
    np.testing.assert_array_equal(m.radii, small["model"].radii)
    np.testing.assert_allclose(m.densities, small["model"].densities, rtol=1e-6,
                               atol=1e-6 * float(np.abs(m.densities).max()))
    np.testing.assert_allclose(m.norm_den, small["model"].norm_den, rtol=1e-6)
    np.testing.assert_allclose(images.maps, small["images"].maps, rtol=1e-6,
                               atol=1e-6 * float(np.abs(images.maps).max()))
    assert want["log_prob"].shape == (small["images"].maps.shape[0],)


def test_stored_map_results_are_the_jax_engines():
    """The stored results are the JAX engine's on the stored problem (raster
    path, rtol 1e-9), and the port's plain branch meets them within
    MAP_VS_JAX with the same best tuples, as on the problem it was made
    from."""
    (p, o, m, images), want = load_map32_jax()
    store = dict(p=p, orients=o, model=m, images=images)
    rj = _jax_results(store, "raster")
    np.testing.assert_allclose(np.asarray(rj.log_prob), want["log_prob"], rtol=1e-9, atol=0)
    eng = make_engine(p, o, m, images, RunConfig(projection="raster"), device="cpu")
    rt = eng.results(eng.run())
    np.testing.assert_allclose(rt.log_prob, want["log_prob"], **MAP_VS_JAX)
    for f in BEST_FIELDS:
        np.testing.assert_array_equal(getattr(rj, f), want[f], err_msg=f)
        np.testing.assert_array_equal(getattr(rt, f), want[f], err_msg=f)


def test_census_matches_the_jax_report(small):
    """The port's census of the 32³ map (core.projection.oob_census, on the
    CPU) against the JAX package's projection_oob_report on the JAX
    package's rotation matrices of the same rows, as its engine calls it:
    the same three counts."""
    import jax.numpy as jnp

    from bioem_tpu.core.orientations import rotation_matrices as jax_rotation_matrices
    from bioem_tpu.core.projection import projection_oob_report as jax_report

    p, m = small["p"], small["model"]
    ang = np.asarray(small["orients"].angles, np.float32)
    rot = np.asarray(jax_rotation_matrices(jnp.asarray(ang), True))
    want = jax_report(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y, m.points, m.radii, rot)
    got = oob_census(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y, m.points, m.radii, ang,
                     True)
    assert want[0] > 0 and got == want


if __name__ == "__main__":
    write_map32_jax()
