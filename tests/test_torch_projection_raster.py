"""G4, the raster projection (ops/project_cuda.raster_project), on the CPU,
against the JAX package.

On CPU tensors the wrapper runs its plain version: the torch calls the
engine made before G4 (rotation_matrices from the block's angle rows, then
core.projection.project_batch). It is held to ``bioem_tpu``'s
``rotation_matrices`` → ``project_batch`` → ``jnp.fft.rfft2`` on the same
rows: the projection within 1e-6·max|a| and the spectra within
2e-6·max|fa|, the tolerances of
test_torch_projection.py::test_raster_project_batch_rfft2 (two f32
rotations and two scatters of the same weights in different orders).
Cases: quaternion and Euler blocks, shifts on and off, stencil_half 0 (all
points point-like) and > 0, points outside the frame in both branches of
the snap, the zero-density padded layout of a mixed-radius pair
(rank.common_model_layout) and the engine's last, partly padded block.

The engine's kernel-branch block step on the CPU through G4's wrapper is
bit-equal to the composition of torch calls it made before G4; its raster
pass (kernel and plain branch) and a ranking of a mixed-radius pair agree
with the JAX engine at the suite's logP tolerances (rtol 1e-9 / atol
1e-7; the kernel branch with every point point-like at 4× its measured
gap, POINT_LIKE_KERNEL), argmax tuples exact.
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
from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.rank import rank_models as j_rank_models
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core import engine as eng_mod
from bioem_tpu_torch.core.orientations import build_orientations
from bioem_tpu_torch.io.model_io import Model
from bioem_tpu_torch.ops import project_cuda as P
from bioem_tpu_torch.rank import common_model_layout, rank_models

from .conftest import tiny_images, tiny_model, tiny_params

SUITE = dict(rtol=1e-9, atol=1e-7)
ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def _angles(rng, o: int, quat: bool, live: int = None) -> np.ndarray:
    """``o`` orientation rows (unit quaternions, or ZXZ Euler angles with a
    zero fourth column as euler_grid lays them out); rows from ``live`` on
    repeat the first, as the engine pads its last block."""
    if quat:
        q = rng.normal(0, 1, (o, 4))
        ang = q / np.linalg.norm(q, axis=1, keepdims=True)
    else:
        ang = np.stack([rng.uniform(-math.pi, math.pi, o), rng.uniform(0, math.pi, o),
                        rng.uniform(-math.pi, math.pi, o), np.zeros(o)], axis=1)
    ang = ang.astype(np.float32)
    if live is not None:
        ang[live:] = ang[0]
    return ang


def _model(rng, kind: str, spread: float) -> Model:
    """The tiny model with spheres (``spheres``), every point point-like
    (``points``: stencil_half 0), or every other point point-like
    (``mixed``)."""
    model = tiny_model(rng, spread=spread, with_radius=kind != "points")
    if kind == "points":
        model.radii[:] = np.float32(0.5)
    elif kind == "mixed":
        model.radii[::2] = np.float32(0.5)
    return model


def _layout(rng, p, model, padded: bool):
    """Both packages' specs and the model arrays as the engine holds them:
    as read, or padded to the common layout of ``model`` and a 40-radius
    model (force_raster; zero-density pad points, the pair's stencil)."""
    pts, radii, dens = model.points, model.radii, model.densities
    s_min = 0
    if padded:
        other = tiny_model(rng, n_points=40)
        other.radii[:] *= np.float32(1.6)  # a wider stencil than ``model`` needs
        lay = common_model_layout(p, [model, other])
        assert lay["force_raster"] and lay["n_points_pad"] == 40
        s_min, pad = lay["stencil_half"], 40 - pts.shape[0]
        pts = np.concatenate([pts, np.repeat(pts[:1], pad, 0)])
        radii = np.concatenate([radii, np.repeat(radii[:1], pad)])
        dens = np.concatenate([dens, np.zeros(pad, np.float32)])
    sj = JP.make_projection_spec(p, model.radii, stencil_half_min=s_min)
    st = TP.make_projection_spec(p, model.radii, stencil_half_min=s_min)
    assert (sj.n_pixels, sj.pixel_size, sj.shift_x, sj.shift_y, sj.stencil_half) == \
        (st.n_pixels, st.pixel_size, st.shift_x, st.shift_y, st.stencil_half)
    return sj, st, (pts, radii, dens, np.float32(model.norm_den))


# name: (quaternions, shift, model kind, spread in Å, padded layout, live rows)
CASES = {
    "quaternion": (True, (0, 0), "spheres", 6.0, False, None),
    "quaternion, shifted": (True, (2, -1), "spheres", 6.0, False, None),
    "euler": (False, (0, 0), "spheres", 6.0, False, None),
    "euler, shifted": (False, (-1, 2), "spheres", 6.0, False, None),
    "stencil_half 0": (True, (1, 1), "points", 6.0, False, None),
    "stencil_half 0, euler": (False, (0, 0), "points", 6.0, False, None),
    "out of frame": (True, (1, 1), "mixed", 12.0, False, None),
    "out of frame, euler": (False, (0, 0), "mixed", 12.0, False, None),
    "padded layout": (True, (2, -1), "spheres", 6.0, True, None),
    "last block, partly padded": (True, (1, 0), "spheres", 6.0, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raster_plain_vs_jax(rng, case):
    quat, shift, kind, spread, padded, live = CASES[case]
    p = tiny_params(shift_x=shift[0], shift_y=shift[1])
    model = _model(rng, kind, spread)
    sj, st, arr = _layout(rng, p, model, padded)
    assert (st.stencil_half == 0) == (kind == "points")
    ang = _angles(rng, 5, quat, live)

    a = np.asarray(JP.project_batch(sj, JO.rotation_matrices(j(ang), quat),
                                    *(j(x) for x in arr)))
    before = P.raster_project.launches
    b = P.raster_project(st, t(ang), *(t(x) for x in arr), use_quaternions=quat)
    assert P.raster_project.launches == before  # CPU tensors take the plain version
    assert b.dtype == torch.float32 and tuple(b.shape) == (5, p.n_pixels, p.n_pixels)
    assert torch.equal(b, P.raster_project_plain(st, t(ang), *(t(x) for x in arr),
                                                 use_quaternions=quat))
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6 * np.abs(a).max())
    fa = np.asarray(jnp.fft.rfft2(j(a)))
    fb = torch.fft.rfft2(b).numpy()
    np.testing.assert_allclose(fb, fa, rtol=0, atol=2e-6 * np.abs(fa).max())

    # what each case is there for
    _i0, _j0, small, valid = TP._snap(p.n_pixels, p.pixel_size, p.shift_x, p.shift_y,
                                      TO.rotation_matrices(t(ang), quat), t(arr[0]), t(arr[1]))
    live_pt = t(arr[2]) != 0
    if spread > 10:  # points leave the frame in both branches
        assert bool((~valid & small & live_pt).any()) and bool((~valid & ~small & live_pt).any())
    if padded:
        assert bool((t(arr[2]) == 0).any()) and st.stencil_half > \
            TP.make_projection_spec(p, model.radii).stencil_half
    if live is not None:
        for o in range(live, 5):
            assert torch.equal(b[o], b[0])


def test_raster_wrapper_refuses_other_devices(rng):
    p = tiny_params()
    model = tiny_model(rng)
    spec = TP.make_projection_spec(p, model.radii)
    meta = [torch.empty(np.shape(x), device="meta") for x in
            (model.points, model.radii, model.densities)]
    with pytest.raises(ValueError, match="unsupported device"):
        P.raster_project(spec, torch.empty((4, 4), device="meta"), *meta,
                         torch.empty((), device="meta"), use_quaternions=True)


def test_raster_snaps_and_scale_are_the_kernels(rng):
    """The check outputs (each point's snap, each orientation's scale) are
    the kernel's: the plain version refuses them."""
    p = tiny_params()
    model = tiny_model(rng)
    spec = TP.make_projection_spec(p, model.radii)
    args = (spec, t(_angles(rng, 2, True)), t(model.points), t(model.radii),
            t(model.densities), t(np.float32(model.norm_den)))
    with pytest.raises(ValueError, match="written by the kernel"):
        P.raster_project(*args, use_quaternions=True,
                         snaps=torch.empty((2, 2, 12), dtype=torch.int32))
    with pytest.raises(ValueError, match="written by the kernel"):
        P.raster_project(*args, use_quaternions=True, scale=torch.empty(2))


def _old_projection(spec, angles, points, radii, densities, norm_den, *, use_quaternions):
    """The raster projection as the engine composed it before G4."""
    return TP.project_batch(spec, TO.rotation_matrices(angles, use_quaternions), points, radii,
                            densities, norm_den)


@pytest.mark.parametrize("quat", [True, False])
def test_engine_raster_kernel_step_equals_the_old_composition(rng, monkeypatch, quat):
    """Every block of a padded pass with per-angle slabs on the raster
    kernel branch, on the CPU: the block step through G4's wrapper gives
    the same state, bit for bit, as the step with the torch composition it
    replaces."""
    p = tiny_params(max_displace_center=4, grid_space_center=2, write_angles=3,
                    shift_x=1, shift_y=-1, use_quaternions=quat, grid_points_quaternion=2)
    eng = eng_mod.BioEMEngine(p, build_orientations(p), tiny_model(rng),
                              tiny_images(rng, 5, p.n_pixels),
                              RunConfig(use_kernels=True, orient_block=3, projection="raster"),
                              device="cpu")
    assert eng.kernel_projection and eng.fspec is None and eng.spec.stencil_half > 0
    assert eng.n_orient_pad > eng.n_orient and eng.orients.use_quaternions == quat
    new, old = eng.initial_state(), eng.initial_state()
    before = P.raster_project.launches
    for b in range(eng.ang_blocks.shape[0]):
        args = (eng.banks, eng.ang_blocks[b], b * eng.o_block, eng.mask_blocks[b])
        eng._block_step(new, *args)
        with monkeypatch.context() as m:
            m.setattr(eng_mod, "project_batch_kernel", _old_projection)
            eng._block_step(old, *args)
    assert P.raster_project.launches == before
    for key, a, b in zip(new._fields, new, old):
        assert a is not None and torch.equal(a, b), key


KCFG_J = dict(use_pallas=True, fused_lse=True, pallas_img_tile=2, projection="raster")
KCFG_T = dict(use_kernels=True, kernel_img_tile=2, projection="raster")
# The kernel branch with every point point-like differs from the JAX Pallas
# path by 5.2e-7 at |logP| ≈ 375 (1.39e-9 relative), just past SUITE: the
# projections agree (the plain branch holds SUITE on them), and the
# fused comparisons' f32 sums run in different orders on the spikier
# single-pixel spectra. Held to 4× the measured error, as
# test_torch_engine.py holds its two such cases.
POINT_LIKE_KERNEL = dict(rtol=0, atol=2.1e-6)
# name: (params, point-like model, jax cfg, port cfg, logP tolerance)
RUNS = {
    "plain branch": ({}, False, dict(projection="raster"), dict(projection="raster"), SUITE),
    "kernel branch": ({}, False, KCFG_J, KCFG_T, SUITE),
    "plain branch, stencil_half 0": ({}, True, dict(projection="raster"),
                                     dict(projection="raster"), SUITE),
    "kernel branch, stencil_half 0": ({}, True, KCFG_J, KCFG_T, POINT_LIKE_KERNEL),
    "kernel branch, quaternions, shifted": (
        dict(use_quaternions=True, grid_points_quaternion=2, shift_x=1, shift_y=-1), False,
        {**KCFG_J, "orient_block": 3}, {**KCFG_T, "orient_block": 3}, SUITE),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_engine_raster_run_vs_jax(rng, case):
    """The port's raster pass against the JAX engine's on the same inputs:
    logP at the suite's tolerances (one case at 4× its measured gap, see
    POINT_LIKE_KERNEL), the argmax tuples exact."""
    pkw, points, jcfg, tcfg, tol = RUNS[case]
    p = tiny_params(**pkw)
    model = tiny_model(rng, with_radius=not points)
    images = tiny_images(rng, 4, p.n_pixels)
    ej = JEngine(p, JO.build_orientations(p), model, images, JConfig(**jcfg))
    et = eng_mod.BioEMEngine(p, build_orientations(p), model, images, RunConfig(**tcfg),
                             device="cpu")
    assert et.fspec is None and (et.spec.stencil_half == 0) == points
    rj, rt = ej.results(ej.run()), et.results(et.run())
    np.testing.assert_allclose(rt.log_prob, rj.log_prob, **tol)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)


def test_rank_mixed_radius_pair_on_the_kernel_branch(rng):
    """rank_models of a mixed-radius pair (one model of 40 distinct radii
    forces the raster for both) on the kernel branch: each model equal to
    the JAX package's ranking at the suite's tolerances and to its own
    engine on the common layout."""
    p = tiny_params()
    models = [tiny_model(rng, n_points=8), tiny_model(rng, n_points=40)]
    images = tiny_images(rng, 2, p.n_pixels)
    cfg = RunConfig(orient_block=2, use_kernels=True, kernel_img_tile=2)
    _, per_image, perf = rank_models(p, build_orientations(p), models, images, cfg, device="cpu")
    _, per_image_j, _ = j_rank_models(p, JO.build_orientations(p), models, images,
                                      JConfig(orient_block=2, use_pallas=True, fused_lse=True,
                                              pallas_img_tile=2))
    np.testing.assert_allclose(per_image, per_image_j, **SUITE)
    lay = common_model_layout(p, models)
    for m, model in enumerate(models):
        own = eng_mod.BioEMEngine(p, build_orientations(p), model, images, cfg, device="cpu",
                                  model_layout=lay)
        assert own.fspec is None
        want = own.results(own.run())
        np.testing.assert_allclose(per_image[m], want.log_prob, **SUITE)
        for f in ARGMAX:
            np.testing.assert_array_equal(getattr(perf["results"][m], f), getattr(want, f))


def test_the_capture_counts_g4():
    """The engine's capture counts G4's launches per replay."""
    assert P.raster_project in eng_mod._kernel_wrappers()
