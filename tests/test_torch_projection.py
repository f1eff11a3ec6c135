"""core/projection.py and the projection kernel's plain version of the port
against bioem_tpu.core.projection / ops.project_pallas (interpret mode).

Rotation matrices agree to 1e-6; the snapped integer pixel positions
exactly; spectra to the f32 rounding floor of a different summation order.
The JAX Pallas kernel builds its phase tables by power doubling (~8 ulp),
the port's reads an exact twiddle table: 5e-5 relative to max|spectrum|,
the bound of tests/test_project_pallas.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bioem_tpu.core.orientations as JO
import bioem_tpu.core.projection as JP
import bioem_tpu_torch.core.orientations as TO
import bioem_tpu_torch.core.projection as TP
from bioem_tpu.ops.project_pallas import fourier_project_block as j_project_block
from bioem_tpu_torch.ops.project_cuda import fourier_project_block as t_project_block

from .conftest import tiny_model, tiny_params


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("quat", [False, True])
def test_rotation_matrices(rng, quat):
    if quat:
        q = rng.normal(0, 1, (20, 4))
        ang = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    else:
        ang = rng.uniform(-math.pi, math.pi, (20, 4)).astype(np.float32)
    a = np.asarray(JO.rotation_matrices(j(ang), quat))
    b = TO.rotation_matrices(t(ang), quat).numpy()
    assert b.shape == (20, 3, 3) and b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=1e-6)


def _fourier_setup(rng, n_orient=4, **pkw):
    p = tiny_params(**pkw)
    model = tiny_model(rng)
    fs_j = JP.make_fourier_projection_spec(p, model.radii)
    fs_t = TP.make_fourier_projection_spec(p, model.radii)
    for a, b in zip(fs_j[1:], fs_t[1:]):
        np.testing.assert_array_equal(a, b)
    assert fs_j[0].__dict__ == fs_t[0].__dict__
    spec, gidx, pmask, st, st_sums = fs_t
    arrays = (model.points[gidx], model.radii[gidx], model.densities[gidx] * pmask,
              np.float32(model.norm_den), st.real.copy(), st.imag.copy(), st_sums)
    q = rng.normal(0, 1, (n_orient, 4))
    ang = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    rot = np.asarray(JO.rotation_matrices(j(ang), True))
    return p, fs_j[0], spec, arrays, rot


@pytest.mark.parametrize("shift", [0, 2])
def test_fourier_prologue_epilogue(rng, shift):
    p, fj, ft, arr, rot = _fourier_setup(rng, shift_x=shift, shift_y=-shift)
    pts, radii, dens, norm_den, st_re, st_im, st_sums = arr
    for o in range(rot.shape[0]):
        a = JP.fourier_prologue(fj, j(rot[o]), j(pts), j(radii), j(dens))
        b = TP.fourier_prologue(ft, t(rot[o]), t(pts), t(radii), t(dens))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        ea = JP.fourier_epilogue(fj, *a, j(norm_den), j(st_re), j(st_im), j(st_sums))
        eb = TP.fourier_epilogue(ft, *b, t(norm_den), t(st_re), t(st_im), t(st_sums))
        scale = max(np.abs(np.asarray(x)).max() for x in ea)
        for x, y in zip(ea, eb):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0, atol=2e-6 * scale)
    # batched form == per-orientation form
    pr, pi = TP.project_fourier_batch(ft, t(rot), *(t(x) for x in arr))
    assert tuple(pr.shape) == (rot.shape[0], p.n_pixels, p.n_fft_1d)


def test_projection_kernel_plain_vs_pallas(rng):
    """K2's plain version (integer positions, exact twiddles) against the
    JAX Pallas kernel in interpret mode (phase increments θ = −2π·i0/N)."""
    p, fj, ft, arr, rot = _fourier_setup(rng, n_orient=3)
    pts, radii, dens, norm_den, st_re, st_im, st_sums = arr
    g, pp, n = ft.n_groups, ft.group_pad, ft.n_pixels

    def regroup_j(x):
        return jnp.transpose(x.reshape(rot.shape[0], g, pp), (1, 0, 2))

    thx, thy, de = (jnp.stack(z) for z in zip(*[
        JP.fourier_prologue(fj, j(r), j(pts), j(radii), j(dens)) for r in rot]))
    ref = j_project_block(regroup_j(thx), regroup_j(thy), regroup_j(de),
                          j(st_re), j(st_im), n=n, interpret=True)
    i0, j0, de_t = TP.fourier_snap(ft, t(rot), t(pts), t(radii), t(dens))
    two_pi_n = np.float32(2 * math.pi / n)
    np.testing.assert_array_equal(-two_pi_n * i0.numpy().astype(np.float32), np.asarray(thx))
    np.testing.assert_array_equal(-two_pi_n * j0.numpy().astype(np.float32), np.asarray(thy))

    def regroup_t(x):
        return x.reshape(rot.shape[0], g, pp).permute(1, 0, 2).contiguous()

    out = t_project_block(regroup_t(i0), regroup_t(j0), regroup_t(de_t),
                          t(st_re), t(st_im), n=n)
    scale = max(np.abs(np.asarray(x)).max() for x in ref)
    err = max(np.abs(y.numpy() - np.asarray(x)).max() for x, y in zip(ref, out)) / scale
    assert err < 5e-5, err
    assert t_project_block.launches == 0  # CPU tensors take the plain version


def test_projection_kernel_path_vs_plain_path(rng):
    """project_fourier_batch_kernel (K2 + scale) == project_fourier_batch."""
    p, fj, ft, arr, rot = _fourier_setup(rng, n_orient=5)
    a = TP.project_fourier_batch(ft, t(rot), *(t(x) for x in arr))
    b = TP.project_fourier_batch_kernel(ft, t(rot), *(t(x) for x in arr))
    scale = max(float(x.abs().max()) for x in a)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) < 5e-5 * scale


@pytest.mark.parametrize("with_radius", [True, False])
def test_raster_project_batch_rfft2(rng, with_radius):
    p = tiny_params(shift_x=1, shift_y=-1)
    model = tiny_model(rng, with_radius=with_radius)
    sj = JP.make_projection_spec(p, model.radii)
    st = TP.make_projection_spec(p, model.radii)
    assert (sj.n_pixels, sj.pixel_size, sj.shift_x, sj.shift_y, sj.stencil_half) == \
        (st.n_pixels, st.pixel_size, st.shift_x, st.shift_y, st.stencil_half)
    q = rng.normal(0, 1, (3, 4))
    ang = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    rot = np.asarray(JO.rotation_matrices(j(ang), True))
    args = (model.points, model.radii, model.densities, np.float32(model.norm_den))
    a = np.asarray(JP.project_batch(sj, j(rot), *(j(x) for x in args)))
    b = TP.project_batch(st, t(rot), *(t(x) for x in args)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())
    fa = np.asarray(jnp.fft.rfft2(j(a)))
    fb = torch.fft.rfft2(t(b)).numpy()
    np.testing.assert_allclose(fb, fa, rtol=0, atol=2e-6 * np.abs(fa).max())


def test_out_of_bounds_reports(rng):
    p = tiny_params()
    model = tiny_model(rng, spread=12.0)
    q = rng.normal(0, 1, (30, 4))
    rot = np.asarray(JO.rotation_matrices(
        j((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)), True))
    args = (p.n_pixels, p.pixel_size, p.shift_x, p.shift_y, model.points, model.radii)
    assert JP.projection_always_in_bounds(*args) == TP.projection_always_in_bounds(*args)
    rep = TP.projection_oob_report(*args, rot)
    assert rep == JP.projection_oob_report(*args, rot)
    assert rep[0] > 0
