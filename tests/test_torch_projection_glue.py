"""G3, the projection's prologue (ops/project_cuda.project_prologue), and
K2's scale epilogue on the CPU, against the JAX package.

G3's plain version (the torch code the engine ran before the kernel) is
held to ``bioem_tpu.core.projection.fourier_prologue`` vmapped over the
block, then the regroup to (G, O, Pp), the group density sums, tempden and
the scale of ``project_fourier_batch_pallas`` (projection.py:444-461):
the snapped pixel positions exactly (recovered from JAX's phase increments
θ = −2π·i0/N, which the port's integers also give bit for bit), the
masked densities exactly, the scale at rtol 1e-6 (two f32 sums of
positive densities in different orders). Cases: quaternion and Euler
blocks, shifts on and off, points outside the frame in both branches
(point-like and sphere), padded groups and the engine's last, partly
padded block. The whole projection from angle rows against JAX's Pallas
path in interpret mode within 5e-5 of max|spectrum| (the bound of
test_torch_projection.py::test_projection_kernel_plain_vs_pallas: the
JAX kernel's phase tables by power doubling against the port's exact
twiddles). K2's plain version given a scale is bit-equal to its unscaled
output times the scale, and the engine's kernel-branch block step on the
CPU is bit-equal to the composition of torch calls it made before G3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bioem_tpu.core.orientations as JO
import bioem_tpu.core.projection as JP
import bioem_tpu_torch.core.orientations as TO
import bioem_tpu_torch.core.projection as TP
from bioem_tpu_torch.ops import project_cuda as P

from .conftest import tiny_images, tiny_model, tiny_params


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


def _setup(rng, shift=(0, 0), spread=6.0, pad=False):
    """Both packages' specs of one tiny model and its grouped model arrays
    (points, radii, densities with the padding zeroed, norm_den, st_re,
    st_im, st_sums)."""
    p = tiny_params(shift_x=shift[0], shift_y=shift[1])
    model = tiny_model(rng, spread=spread)
    n_groups = np.unique(model.radii).size
    kw = dict(n_groups_pad=n_groups + 3, group_pad=16) if pad else {}
    fs_j = JP.make_fourier_projection_spec(p, model.radii, **kw)
    fs_t = TP.make_fourier_projection_spec(p, model.radii, **kw)
    spec, gidx, pmask, st, st_sums = fs_t
    for a, b in zip(fs_j[1:], fs_t[1:]):
        np.testing.assert_array_equal(a, b)
    arrays = (model.points[gidx], model.radii[gidx], model.densities[gidx] * pmask,
              np.float32(model.norm_den), st.real.copy(), st.imag.copy(), st_sums)
    return p, fs_j[0], spec, arrays


# name: (quaternions, shift, spread of the model in Å, padded layout, live rows)
CASES = {
    "quaternion": (True, (0, 0), 6.0, False, None),
    "quaternion, shifted": (True, (2, -1), 6.0, False, None),
    "euler": (False, (0, 0), 6.0, False, None),
    "euler, shifted": (False, (-1, 2), 6.0, False, None),
    "out of frame": (True, (1, 1), 12.0, False, None),
    "out of frame, euler": (False, (0, 0), 12.0, False, None),
    "padded groups": (True, (2, -1), 6.0, True, None),
    "last block, partly padded": (True, (1, 0), 6.0, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prologue_plain_vs_jax(rng, case):
    quat, shift, spread, pad, live = CASES[case]
    p, fj, ft, arr = _setup(rng, shift, spread, pad)
    pts, radii, dens, norm_den, _st_re, _st_im, st_sums = arr
    o_n, g, pp, n = 5, ft.n_groups, ft.group_pad, ft.n_pixels
    ang = _angles(rng, o_n, quat, live)

    rot = JO.rotation_matrices(j(ang), quat)
    thx, thy, de_j = jax.vmap(
        lambda rm: JP.fourier_prologue(fj, rm, j(pts), j(radii), j(dens)))(rot)

    def regroup(x):  # (O, G·Pp) → (G, O, Pp), as project_fourier_batch_pallas
        return np.transpose(np.asarray(x).reshape(o_n, g, pp), (1, 0, 2))

    # project_fourier_batch_pallas's group sums, tempden and scale
    group_dens = jnp.sum(de_j.reshape(o_n, g, pp), axis=2)
    tempden = jnp.matmul(group_dens, j(st_sums), precision=jax.lax.Precision.HIGHEST)
    scale_j = np.asarray(j(norm_den) / tempden)

    before = P.project_prologue.launches
    i0, j0, de, scale = P.project_prologue(ft, t(ang), t(pts), t(radii), t(dens), t(norm_den),
                                           t(st_sums), use_quaternions=quat)
    assert P.project_prologue.launches == before  # CPU tensors take the plain version
    assert i0.dtype == j0.dtype == torch.int32 and de.dtype == scale.dtype == torch.float32
    assert tuple(i0.shape) == tuple(de.shape) == (g, o_n, pp) and tuple(scale.shape) == (o_n,)

    two_pi_n = np.float32(2 * math.pi / n)
    for mine, theta in ((i0, thx), (j0, thy)):
        np.testing.assert_array_equal(mine.numpy(), np.rint(-regroup(theta) / two_pi_n))
        np.testing.assert_array_equal(-two_pi_n * mine.numpy().astype(np.float32),
                                      regroup(theta))
    np.testing.assert_array_equal(de.numpy(), regroup(de_j))
    np.testing.assert_allclose(scale.numpy(), scale_j, rtol=1e-6, atol=0)

    small = radii <= np.float32(p.pixel_size)
    dropped = (regroup(de_j) == 0) & (dens > 0).reshape(g, 1, pp)
    if spread > 10:  # points leave the frame in both branches
        assert dropped[small.reshape(g, 1, pp).repeat(o_n, 1)].any()
        assert dropped[~small.reshape(g, 1, pp).repeat(o_n, 1)].any()
    if pad:  # padded slots and groups carry no density
        assert not de.numpy()[dens.reshape(g, 1, pp).repeat(o_n, 1) == 0].any()
    if live is not None:
        for o in range(live, o_n):
            assert torch.equal(i0[:, o], i0[:, 0]) and torch.equal(de[:, o], de[:, 0])
            assert scale[o] == scale[0]


@pytest.mark.parametrize("quat", [True, False])
def test_projection_from_angle_rows_vs_pallas(rng, quat):
    """G3 + K2 (plain versions) from the angle rows against the JAX
    package's Pallas path (interpret mode) on those rows' rotations."""
    p, fj, ft, arr = _setup(rng, shift=(1, -1))
    ang = _angles(rng, 3, quat)
    ref = JP.project_fourier_batch_pallas(fj, JO.rotation_matrices(j(ang), quat),
                                          *(j(x) for x in arr), interpret=True)
    out = TP.project_fourier_batch_kernel(ft, t(ang), *(t(x) for x in arr),
                                          use_quaternions=quat)
    scale = max(np.abs(np.asarray(x)).max() for x in ref)
    err = max(np.abs(y.numpy() - np.asarray(x)).max() for x, y in zip(ref, out)) / scale
    assert err < 5e-5, err


def test_k2_plain_scale_is_one_product(rng):
    """K2's plain version given a scale is its unscaled output times the
    scale, bit for bit (the product the caller rounded before K2 took the
    scale), and the wrapper on CPU tensors is that plain version."""
    p, fj, ft, arr = _setup(rng)
    pts, radii, dens, norm_den, st_re, st_im, st_sums = (t(x) for x in arr)
    i0, j0, de, scale = P.project_prologue_plain(ft, t(_angles(rng, 4, True)), pts, radii, dens,
                                                 norm_den, st_sums, use_quaternions=True)
    counts = P.counts_tensor(ft.group_counts, "cpu")
    kw = dict(n=ft.n_pixels, counts=counts)
    ur, ui = P.fourier_project_block_plain(i0, j0, de, st_re, st_im, **kw)
    sr, si = P.fourier_project_block_plain(i0, j0, de, st_re, st_im, scale=scale, **kw)
    assert torch.equal(sr, ur * scale[:, None, None]) and torch.equal(si, ui * scale[:, None, None])
    before = P.fourier_project_block.launches
    wr, wi = P.fourier_project_block(i0, j0, de, st_re, st_im, scale=scale, **kw)
    assert torch.equal(wr, sr) and torch.equal(wi, si)
    assert P.fourier_project_block.launches == before


def test_prologue_refuses_other_devices(rng):
    p, fj, ft, arr = _setup(rng)
    meta = [torch.empty(np.shape(x), device="meta") for x in arr]
    with pytest.raises(ValueError, match="unsupported device"):
        P.project_prologue(ft, torch.empty((4, 4), device="meta"), *meta[:4], meta[6],
                           use_quaternions=True)


def _old_projection(fspec, angles, points, radii, densities, norm_den, st_re, st_im, st_sums,
                    counts=None, *, use_quaternions):
    """The kernel projection as the engine composed it from torch calls
    before G3: the rotation matrices, the snap regrouped, K2 unscaled,
    then tempden and the scale."""
    rotm = TO.rotation_matrices(angles, use_quaternions)
    i0, j0, de = TP.grouped_snap(fspec, rotm, points, radii, densities)
    pr, pi = P.fourier_project_block(i0, j0, de, st_re, st_im, n=fspec.n_pixels, counts=counts)
    tempden = torch.matmul(de.sum(dim=2).T, st_sums.to(torch.float32))
    scale = (norm_den / tempden)[:, None, None]
    return pr * scale, pi * scale


@pytest.mark.parametrize("quat", [True, False])
def test_engine_kernel_step_equals_the_old_composition(rng, monkeypatch, quat):
    """Every block of a padded pass with per-angle slabs on the kernel
    branch, on the CPU: the block step through G3 and K2 with the scale
    gives the same state, bit for bit, as the step with the torch
    composition they replace."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core import engine as eng_mod
    from bioem_tpu_torch.core.orientations import build_orientations

    p = tiny_params(max_displace_center=4, grid_space_center=2, write_angles=3,
                    shift_x=1, shift_y=-1, use_quaternions=quat, grid_points_quaternion=2)
    eng = eng_mod.BioEMEngine(p, build_orientations(p), tiny_model(rng),
                              tiny_images(rng, 5, p.n_pixels),
                              RunConfig(use_kernels=True, orient_block=3), device="cpu")
    assert eng.kernel_projection and eng.fspec is not None
    assert eng.n_orient_pad > eng.n_orient and eng.orients.use_quaternions == quat
    new, old = eng.initial_state(), eng.initial_state()
    before = P.project_prologue.launches
    for b in range(eng.ang_blocks.shape[0]):
        args = (eng.banks, eng.ang_blocks[b], b * eng.o_block, eng.mask_blocks[b])
        eng._block_step(new, *args)
        with monkeypatch.context() as m:
            m.setattr(eng_mod, "project_fourier_batch_kernel", _old_projection)
            eng._block_step(old, *args)
    assert P.project_prologue.launches == before
    for key, a, b in zip(new._fields, new, old):
        assert a is not None and torch.equal(a, b), key


def test_the_capture_counts_g3():
    """The engine's capture counts G3's launches per replay."""
    from bioem_tpu_torch.core.engine import _kernel_wrappers

    assert P.project_prologue in _kernel_wrappers()
