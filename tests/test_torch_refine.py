"""The port's continuous refinement (bioem_tpu_torch/refine.py) against
bioem_tpu.refine on the same inputs: its pieces, its objective, the
planted case and the CLI. The CTF variants and the two refinement faults
the port fixes (F1, F2) are in test_torch_refine_faults.py.

Tolerances (stated by the port's acceptance contract): exp_so3, the smooth
projection phases and the smooth CTF/PSF spectrum rtol 1e-6 / atol 1e-6;
the continuous cross-correlation in f64 rtol 1e-12; the signed-row Fourier
epilogue atol 1e-5 of the spectrum's largest magnitude (its values reach
~7e2 here, where the f32 spacing is 6e-5); the objective's value 1e-6 relative, its gradient 1e-4
and Hessian 1e-3 of their largest entry (f32 heavy path); refine_results:
logpro_seed 1e-6 relative, refined rotations 2e-3 rad, displacements 1e-2
px, and logpro_refined 1e-4 absolute plus 2e-7 of |logpro_refined|. That
second term is measured, not assumed: the two refinements end 2.2e-4 apart
at the planted peak (logpro 1703.17, seed 342) and 3.6e-4 apart on the
amplitude case (2560.45), i.e. 1.3e-7 and 1.4e-7 relative, with rotations
1.8e-7 rad and displacements 1.6e-6 px apart. The f64 solve is not the
cause: the port with the JAX package's f32 solve plus one refinement step
ends on the same point to every printed digit. The cause is the
objective's f32 heavy path (XLA's and torch's summation orders differ):
near the peak the damped Newton accepts or rejects steps whose gains are
at that noise level, so each package stops at its own point of a plateau
whose values spread ~1e-7 relative.

One JAX and one port refinement per case, shared through module fixtures.
"""
# The tolerances above are shared with test_torch_refine_faults.py through
# _hold_to_jax.

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioem_tpu import refine as JR
from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.core.orientations import rotation_matrices as j_rotmats
from bioem_tpu.core.projection import fourier_epilogue as j_epilogue
from bioem_tpu_torch import refine as TR
from bioem_tpu_torch.config import RunConfig as TConfig
from bioem_tpu_torch.core.engine import BioEMEngine as TEngine
from bioem_tpu_torch.core.orientations import build_orientations as t_orients
from bioem_tpu_torch.core.projection import fourier_epilogue as t_epilogue

from .conftest import tiny_images, tiny_model, tiny_params
from .test_refine import _angular_error, _params, _synth_image

ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The refinement's small batched tensors run no faster on several
    threads (measured: equal times on 1 and 8), and the test workers share
    the machine's cores: one torch thread per worker avoids contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dt=None):
    return torch.as_tensor(np.asarray(x), dtype=dt)


def _engines(p, model, images):
    """The JAX and port engines on the same inputs, run; their results."""
    ej = JEngine(p, j_orients(p), model, images, JConfig(orient_block=4))
    et = TEngine(p, t_orients(p), model, images, TConfig(orient_block=4), device="cpu")
    rj, rt = ej.results(ej.run()), et.results(et.run())
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)
    return ej, rj, et, rt


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("omega", [[0.0, 0.0, 0.0], [0.05, -0.03, 0.02], [0.7, 0.2, -1.1]])
def test_exp_so3_matches(omega):
    got = TR.exp_so3(_t(omega, torch.float32)).numpy()
    want = np.asarray(JR.exp_so3(jnp.asarray(omega, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _small_engine(rng, n_img=1, **pkw):
    p = _params(**pkw)
    model = tiny_model(rng, n_points=10)
    images = tiny_images(rng, n_img, p.n_pixels)
    ej = JEngine(p, j_orients(p), model, images, JConfig(orient_block=4))
    et = TEngine(p, t_orients(p), model, images, TConfig(orient_block=4), device="cpu")
    return p, ej, et


def test_smooth_projection_phases_and_signed_epilogue_match(rng):
    p, ej, et = _small_engine(rng, shift_x=1, shift_y=-1)
    rot = np.asarray(JR.exp_so3(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    bj, bt = ej.banks, et.banks
    jx, jy = JR.smooth_projection_phases(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y,
                                         jnp.asarray(rot), bj.points, bj.radii)
    tx, ty = TR.smooth_projection_phases(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y,
                                         _t(rot), bt.points, bt.radii)
    for a, b in ((tx, jx), (ty, jy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    out = {}
    for signed in (True, False):
        pj = j_epilogue(ej.fspec, jx, jy, bj.dens, bj.norm_den, bj.st_re, bj.st_im, bj.st_sums,
                        signed_rows=signed)
        out[signed] = t_epilogue(et.fspec, tx, ty, bt.dens, bt.norm_den, bt.st_re, bt.st_im,
                                 bt.st_sums, signed_rows=signed)
        scale = max(float(np.abs(np.asarray(x)).max()) for x in pj)
        for a, b in zip(out[signed], pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5 * scale)
    # signed and raw rows differ at fractional positions
    assert not torch.allclose(out[True][0], out[False][0])


@pytest.mark.parametrize("mode", ["ctf", "psf"])
def test_smooth_ctf_spectrum_matches(mode):
    n, pix = 24, 1.5
    amp, pha, env = 0.3, 0.9, 40.0
    kw_j, kw_t = {}, {}
    if mode == "psf":
        k1 = np.arange(n)
        ph_n = 2.0 * np.pi * np.outer(k1, k1) / n
        ph_f = 2.0 * np.pi * np.outer(np.arange(n // 2 + 1), k1) / n
        tabs = {"cos_n": np.cos(ph_n), "sin_n": np.sin(ph_n),
                "cos_f": np.cos(ph_f), "sin_f": np.sin(ph_f)}
        kw_j = {k: jnp.asarray(v, jnp.float32) for k, v in tabs.items()}
        kw_t = {k: _t(v, torch.float32) for k, v in tabs.items()}
        pha, env = 1.2, 0.4
    use_psf = mode == "psf"
    want = np.asarray(JR.smooth_ctf_spectrum(
        n, pix, use_psf, jnp.float32(amp), jnp.float32(pha), jnp.float32(env), **kw_j))
    got = TR.smooth_ctf_spectrum(n, pix, use_psf, _t(amp, torch.float32), _t(pha, torch.float32),
                                 _t(env, torch.float32), **kw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cc_at_matches_in_f64(rng):
    n = 24
    p_re = rng.normal(size=(n, n // 2 + 1))
    p_im = rng.normal(size=(n, n // 2 + 1))
    for d in ([0.0, 0.0], [0.37, -1.61], [3.0, 2.5]):
        want = float(JR._cc_at(jnp.asarray(p_re), jnp.asarray(p_im), n, jnp.asarray(d)))
        got = float(TR._cc_at(_t(p_re), _t(p_im), n, _t(d, torch.float64)))
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12 * np.abs(p_re).sum())


# ---------------------------------------------------------------------------
# The objective: value, gradient and Hessian
# ---------------------------------------------------------------------------

def test_objective_value_gradient_hessian_match(rng):
    p, ej, et = _small_engine(rng)
    bj, bt = ej.banks, et.banks
    static_j = {
        "n": p.n_pixels, "ntot": float(p.n_total_pixels), "pixel_size": float(p.pixel_size),
        "shift_x": 0, "shift_y": 0, "use_psf": False, "fspec": ej.fspec, "p_obj": p,
        "points": bj.points, "radii": bj.radii, "dens": bj.dens, "norm_den": bj.norm_den,
        "st_re": bj.st_re, "st_im": bj.st_im, "st_sums": bj.st_sums, "h": bj.h,
    }
    static_t = TR.refine_static(et)
    static_t["ctf_free"] = (True, True, True)  # JAX's _logpro_smooth moves every axis
    rot0 = np.asarray(j_rotmats(jnp.asarray(ej.orients.angles[3:4]), False))[0]
    cj = {"rot0": jnp.asarray(rot0), "amp0": bj.amp[0], "pha0": bj.pha[0], "env0": bj.env[0],
          "d0": jnp.asarray([0.5, -1.0]), "img_re": bj.img_re[0], "img_im": bj.img_im[0],
          "sum_ref": bj.sum_ref[0], "ssq_ref": bj.ssq_ref[0]}
    ct = {"rot0": _t(rot0), "amp0": bt.amp[0], "pha0": bt.pha[0], "env0": bt.env[0],
          "d0": _t([0.5, -1.0], torch.float64), "img_re": bt.img_re[0], "img_im": bt.img_im[0],
          "sum_ref": bt.sum_ref[0], "ssq_ref": bt.ssq_ref[0]}

    def theta(v):
        return {"omega": v[:3], "d": v[3:5], "dctf": v[5:8]}

    def fj(v):
        return JR._logpro_smooth(theta(v), cj, static_j)

    def ft(v, c):
        return TR._logpro_smooth(theta(v), c, static_t)

    vecs = [np.zeros(8)] + [
        np.concatenate([rng.normal(0, 0.05, 3), rng.uniform(-0.5, 0.5, 2),
                        [rng.normal(0, 0.01), rng.normal(0, 0.5), rng.normal(0, 0.02)]])
        for _ in range(3)
    ]
    jgrad, jhess = jax.jit(jax.grad(fj)), jax.jit(jax.hessian(fj))
    for v in vecs:
        val_j = float(fj(jnp.asarray(v)))
        g_j = np.asarray(jgrad(jnp.asarray(v)))
        h_j = np.asarray(jhess(jnp.asarray(v)))
        vt = _t(v, torch.float64)
        val_t = float(ft(vt, ct))
        h_t, g_t = TR._hess_grad(ft)(vt, ct)
        assert val_t == pytest.approx(val_j, rel=1e-6)
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()
        assert np.abs(h_t.numpy() - h_j).max() <= 1e-3 * np.abs(h_j).max()


# ---------------------------------------------------------------------------
# refine_results: the planted case and the CTF variants (tests/test_refine.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    """tests/test_refine.py:165-224's planted case, refined once by each
    package with the defaults (16 starts, 60 iterations)."""
    rng = np.random.default_rng(1234)
    p = _params(start_defocus=0.3, end_defocus=0.7)
    orients = j_orients(p)
    model = tiny_model(rng, n_points=10)
    base = np.asarray(j_rotmats(jnp.asarray(orients.angles[7]), orients.use_quaternions),
                      np.float64)
    rot_star = np.asarray(JR.exp_so3(jnp.asarray([0.05, -0.045, 0.04]))) @ base
    d_star = np.array([0.6, -0.4])
    boot = JEngine(p, orients, model, tiny_images(rng, 1, p.n_pixels), JConfig(orient_block=4))
    images = _synth_image(boot, rot_star, 1, d_star, rng, noise_sigma=0.05)
    ej, rj, et, rt = _engines(p, model, images)
    return dict(ej=ej, rj=rj, et=et, rt=rt, oj=JR.refine_results(ej, rj),
                ot=TR.refine_results(et, rt), rot_star=rot_star, d_star=d_star)


def _hold_to_jax(c):
    oj, ot = c["oj"], c["ot"]
    np.testing.assert_allclose(ot.logpro_seed, oj.logpro_seed, rtol=1e-6)
    for i in range(len(oj.logpro_seed)):
        tol = 1e-4 + 2e-7 * abs(oj.logpro_refined[i])
        assert abs(ot.logpro_refined[i] - oj.logpro_refined[i]) <= tol, (
            ot.logpro_refined[i], oj.logpro_refined[i])
        assert _angular_error(ot.rotmat[i], oj.rotmat[i]) <= 2e-3
    np.testing.assert_allclose(ot.cent_x, oj.cent_x, rtol=0, atol=1e-2)
    np.testing.assert_allclose(ot.cent_y, oj.cent_y, rtol=0, atol=1e-2)
    assert np.all(ot.logpro_refined >= ot.logpro_seed)
    assert np.all(np.isfinite(ot.grad_norm))
    np.testing.assert_allclose(np.linalg.norm(ot.quaternion, axis=1), 1.0, atol=1e-6)


def test_refine_planted_matches_jax_and_recovers(planted):
    c = planted
    _hold_to_jax(c)
    ot, rt, et = c["ot"], c["rt"], c["et"]
    # the port recovers the planted parameters as tests/test_refine.py asks
    seed_rot = np.asarray(j_rotmats(jnp.asarray(et.orients.angles[rt.best_orient[0]]),
                                    et.orients.use_quaternions), np.float64)
    ang_seed = _angular_error(seed_rot, c["rot_star"])
    ang_ref = _angular_error(ot.rotmat[0], c["rot_star"])
    assert ang_ref < ang_seed and ang_ref < 0.04, (ang_ref, ang_seed)
    d_star = c["d_star"]
    seed_err = np.hypot(rt.best_cent_x[0] - d_star[0], rt.best_cent_y[0] - d_star[1])
    ref_err = np.hypot(ot.cent_x[0] - d_star[0], ot.cent_y[0] - d_star[1])
    assert ref_err < seed_err and ref_err < 0.25, (ref_err, seed_err)


def test_refine_raster_engine_rejected(rng):
    p = _params()
    model = tiny_model(rng, n_points=10)
    images = tiny_images(rng, 1, p.n_pixels)
    eng = TEngine(p, t_orients(p), model, images, TConfig(orient_block=4), device="cpu",
                  model_layout={"force_raster": True})
    res = eng.results(eng.run())
    with pytest.raises(ValueError, match="Fourier projection layout"):
        TR.refine_results(eng, res)


def test_refine_image_chunks_equal(rng):
    """Images refined in chunks of one equal the images refined together."""
    p, ej, et = _small_engine(rng, n_img=3)
    res = et.results(et.run())
    whole = TR.refine_results(et, res, n_starts=3, iters=4)
    parts = TR.refine_results(et, res, n_starts=3, iters=4, image_chunk=1)
    assert whole.image_chunk == 3 and parts.image_chunk == 1
    np.testing.assert_allclose(parts.logpro_refined, whole.logpro_refined, rtol=1e-12)
    np.testing.assert_allclose(parts.rotmat, whole.rotmat, rtol=0, atol=1e-12)


def parse_refined(text: str) -> np.ndarray:
    """Output_Refined's rows as floats: RefMap, LogProSeed, LogProRefined,
    q1..q4, CentX, CentY, Pha, Env, Amp, GradNorm."""
    rows = []
    for line in text.splitlines():
        if line.startswith("RefMap:"):
            tok = line.replace("->", " ").split()
            rows.append([float(x) for x in tok if x[0].isdigit() or x[0] in "-."
                         or x.lower() in ("nan", "inf", "-inf")])
    return np.array(rows)


def test_cli_refine_writes_output_refined(tmp_path, monkeypatch):
    """--Refine through the port's CLI on golden case A (CPU): one finite
    Output_Refined row per image, each refined logpro ≥ its seed, unit
    quaternions."""
    import shutil

    from bioem_tpu_torch.cli import main

    from .test_golden import DATA

    shutil.copytree(os.path.join(DATA, "case_a_euler_ctf"), tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    monkeypatch.setenv("BIOEM_DEBUG_NMAPS", "2")  # two of its images: the CLI refines with
    assert main(["--Modelfile", "model.txt", "--Particlesfile", "maps.txt", "--Inputfile",
                 "param.txt", "--Refine"]) == 0  # the defaults (16 starts, 60 iterations)
    rows = parse_refined(open("Output_Refined").read())
    n_img = len({ln.split()[1] for ln in open("Output_Probabilities") if ln.startswith("RefMap:")})
    assert rows.shape == (n_img, 13) and n_img > 0
    assert np.all(np.isfinite(rows))
    assert np.all(rows[:, 2] >= rows[:, 1])
    np.testing.assert_allclose(np.linalg.norm(rows[:, 3:7], axis=1), 1.0, atol=2e-6)
