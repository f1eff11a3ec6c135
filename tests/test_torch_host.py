"""The port's NumPy host layer equals bioem_tpu's, exactly, on the golden
inputs: parameters, CTF bank, orientation grids, displacement lists, image
ingest (text, MRC, multi-MRC), model ingest (text, PDB, voxel MRC), the
output writers, and the forward simulator's BEST_* parameters and maps. The port carries its own copies of these modules (the JAX
package imports JAX at package import), so this pins them together.
"""

import dataclasses
import io
import os

import numpy as np
import pytest

import bioem_tpu.core.ctf as j_ctf
import bioem_tpu.core.orientations as j_or
import bioem_tpu.io.map_io as j_map
import bioem_tpu.io.model_io as j_model
import bioem_tpu.io.output as j_out
import bioem_tpu.params as j_params
import bioem_tpu.simulator as j_sim
import bioem_tpu_torch.core.ctf as t_ctf
import bioem_tpu_torch.core.orientations as t_or
import bioem_tpu_torch.io.map_io as t_map
import bioem_tpu_torch.io.model_io as t_model
import bioem_tpu_torch.io.output as t_out
import bioem_tpu_torch.params as t_params
import bioem_tpu_torch.simulator as t_sim

from .test_golden import CASES, DATA

CASE_IDS = sorted(CASES)


def _same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for k in da:
            _same(da[k], db[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b or (a != a and b != b), (a, b)


def _args(case):
    model_file, maps_file, extra, *_ = CASES[case]
    src = os.path.join(DATA, case)
    orient = extra[extra.index("--ReadOrientation") + 1] if "--ReadOrientation" in extra else None
    return src, model_file, maps_file, extra, orient


def _in_case_dir(case, fn):
    old = os.getcwd()
    os.chdir(os.path.join(DATA, case))
    try:
        return fn()
    finally:
        os.chdir(old)


@pytest.mark.parametrize("case", CASE_IDS)
def test_params_ctf_orientations_displacements(case):
    src, _, _, _, orient = _args(case)
    path = os.path.join(src, "param.txt")
    pj = j_params.read_parameters(path, not_uniform_angles=orient is not None)
    pt = t_params.read_parameters(path, not_uniform_angles=orient is not None)
    _same(pj, pt)
    gj, gt = j_params.make_ctf_grid(pj), t_params.make_ctf_grid(pt)
    _same(gj, gt)
    np.testing.assert_array_equal(j_ctf.build_ctf_bank(pj, gj), t_ctf.build_ctf_bank(pt, gt))
    for a, b in zip(j_params.displacement_lists(pj), t_params.displacement_lists(pt)):
        np.testing.assert_array_equal(a, b)
    of = os.path.join(src, orient) if orient else None
    _same(j_or.build_orientations(pj, of), t_or.build_orientations(pt, of))
    volu_j = j_params.orientation_volume_quirked(pj, 0.37, gj)
    assert volu_j == t_params.orientation_volume_quirked(pt, 0.37, gt)
    assert j_params.log_normalization_constant(pj, volu_j) == \
        t_params.log_normalization_constant(pt, volu_j)


@pytest.mark.parametrize("case", CASE_IDS)
def test_image_ingest(case):
    src, _, maps_file, extra, orient = _args(case)
    p = t_params.read_parameters(os.path.join(src, "param.txt"),
                                 not_uniform_angles=orient is not None)
    kw = dict(read_mrc="--ReadMRC" in extra, read_mult_mrc="--ReadMultipleMRC" in extra,
              normalize=not p.no_map_norm)
    sj = _in_case_dir(case, lambda: j_map.read_ref_maps(maps_file, p.n_pixels, **kw))
    st = _in_case_dir(case, lambda: t_map.read_ref_maps(maps_file, p.n_pixels, **kw))
    np.testing.assert_array_equal(sj.maps, st.maps)
    assert sj.maps.dtype == st.maps.dtype == np.float32


@pytest.mark.parametrize("case", CASE_IDS)
def test_model_ingest(case):
    src, model_file, _, extra, orient = _args(case)
    p = t_params.read_parameters(os.path.join(src, "param.txt"),
                                 not_uniform_angles=orient is not None)
    kw = dict(read_pdb="--ReadPDB" in extra, read_mrc="--ReadModelMRC" in extra,
              pixel_size=p.pixel_size, ignore_pdb=p.ignore_pdb,
              center_mass=not p.no_center_mass)
    mj = _in_case_dir(case, lambda: j_model.read_model(model_file, **kw))
    mt = _in_case_dir(case, lambda: t_model.read_model(model_file, **kw))
    _same(mj, mt)


def _fake_results(rng, n_img, n_orient, n_ctf, with_angles):
    from bioem_tpu_torch.core.engine import Results

    ang = rng.normal(-50, 5, (n_img, n_orient)) if with_angles else None
    return Results(
        log_prob=rng.normal(-300, 20, n_img), constoadd=rng.normal(-290, 20, n_img),
        total=rng.uniform(1, 5, n_img), best_orient=rng.integers(0, n_orient, n_img),
        best_conv=rng.integers(0, n_ctf, n_img), best_cent_x=rng.integers(-3, 4, n_img),
        best_cent_y=rng.integers(-3, 4, n_img), best_norm=rng.normal(1, 0.1, n_img),
        best_mu=rng.normal(0, 0.1, n_img), angle_log=ang, log_norm_const=-12.5,
        angle_raw=(ang - 1.0, np.full_like(ang, 1.0)) if with_angles else None,
    )


@pytest.mark.parametrize("case", CASE_IDS)
def test_output_writers(case, rng):
    """Same results → byte-identical Output_Probabilities and ANG_PROB."""
    src, _, _, _, orient = _args(case)
    p = t_params.read_parameters(os.path.join(src, "param.txt"),
                                 not_uniform_angles=orient is not None)
    of = os.path.join(src, orient) if orient else None
    orients = t_or.build_orientations(p, of)
    grid = t_params.make_ctf_grid(p)
    res = _fake_results(rng, 5, orients.n, grid.n, True)
    for writer_j, writer_t in ((j_out.write_probabilities, t_out.write_probabilities),):
        fj, ft = io.StringIO(), io.StringIO()
        writer_j(fj, p, orients, grid, res)
        writer_t(ft, p, orients, grid, res)
        assert fj.getvalue() == ft.getvalue()
    if p.write_angles:
        fj, ft = io.StringIO(), io.StringIO()
        j_out.write_angle_probabilities(fj, p, orients, res)
        t_out.write_angle_probabilities(ft, p, orients, res)
        assert fj.getvalue() == ft.getvalue() and fj.getvalue()


BEST_EXTRA = {
    "golden_case_m": None,  # tests/golden/data/case_m_bestmap/best.txt itself
    "quat_psf_noise": ("PIXEL_SIZE 2.0\nNUMBER_PIXELS 16\nUSE_QUATERNIONS\nBEST_Q1 0.1\n"
                       "BEST_Q2 -0.3\nBEST_Q3 0.5\nBEST_Q4 0.8\nUSE_PSF\n"
                       "BEST_PSF_ENVELOPE 20.0\nBEST_PSF_PHASE 2.0\nBEST_PSF_AMP 0.3\n"
                       "WITHNOISE 0.5\nNO_PROJECT_RADIUS\n# a comment\n\n"),
    "shift_dx": ("PIXEL_SIZE 1.5\nNUMBER_PIXELS 16\nBEST_ALPHA 0.7\nBEST_BETA 1.1\n"
                 "BEST_GAMMA -0.4\nBEST_CTF_B_ENV 80.0\nBEST_CTF_DEFOCUS 2.0\n"
                 "BEST_CTF_AMP 0.2\nSHIFT_X 1\nSHIFT_Y -1\nBEST_DX 3\nBEST_DY -2\n"
                 "BEST_NORM 0.7\nBEST_OFFSET 1.5\n"),
}


def _best_path(name, tmp_path):
    if BEST_EXTRA[name] is None:
        return os.path.join(DATA, "case_m_bestmap", "best.txt")
    path = tmp_path / "best.txt"
    path.write_text(BEST_EXTRA[name])
    return str(path)


@pytest.mark.parametrize("name", sorted(BEST_EXTRA))
def test_best_params_and_simulator(name, tmp_path):
    """BestParams parsing, best_to_params, the synthesised map, the BESTMAP
    text (noise from one seed) and BestmapCalcCC equal the JAX package's."""
    path = _best_path(name, tmp_path)
    bj, bt = j_params.read_best_params(path), t_params.read_best_params(path)
    _same(bj, bt)
    pj, pt = j_params.best_to_params(bj), t_params.best_to_params(bt)
    _same(pj, pt)
    assert pj._finalized and pt._finalized
    model = _in_case_dir("case_m_bestmap", lambda: t_model.read_model(
        "model.txt", pixel_size=bt.pixel_size, center_mass=not bt.no_center_mass))
    rj, rt = j_sim.synthesize_best_map(bj, model), t_sim.synthesize_best_map(bt, model)
    _same(rj, rt)
    fj, ft = io.StringIO(), io.StringIO()
    j_sim.write_best_map(bj, model, fj, rng=np.random.default_rng(7))
    t_sim.write_best_map(bt, model, ft, rng=np.random.default_rng(7))
    assert fj.getvalue() == ft.getvalue() and "MAP " in ft.getvalue()
    ref_map = np.random.default_rng(3).normal(0, 1, (bt.n_pixels, bt.n_pixels))
    assert j_sim.bestmap_cc(bj, model, ref_map) == t_sim.bestmap_cc(bt, model, ref_map)


@pytest.mark.parametrize("text,match", [
    ("USE_PSF\nBEST_CTF_AMP 0.1\n", "PSF and CTF"),
    ("USE_QUATERNIONS\nBEST_Q1 1.5\n", "Quaternion"),
])
def test_best_params_errors(text, match, tmp_path):
    path = tmp_path / "best.txt"
    path.write_text("PIXEL_SIZE 1.0\nNUMBER_PIXELS 8\n" + text)
    for mod in (j_params, t_params):
        with pytest.raises(mod.ParamError, match=match):
            mod.read_best_params(str(path))
