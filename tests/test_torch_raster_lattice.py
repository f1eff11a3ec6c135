"""G4's lattice variant on the CPU: the detector that picks it
(core.projection.lattice_axes), the layouts and swaps that keep or refuse
it (rank.common_model_layout, BioEMEngine.swap_model), its counter, and a
plain NumPy twin of the lattice kernel's walk (csrc/project_raster.cu
``raster_projection_kernel_lattice``): the same float32 operations in the
same order for the plane axis, the axes' fit, and a plane's rows and each
row's columns around the widened tile with the walk's one-pixel margin,
held on ~200 orientations of a 48³ map (axis-aligned, 45°, body
diagonals, q and −q, shifts) to the rules the kernel's projection rests
on. The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bioem_tpu_torch.config import RunConfig  # noqa: E402
from bioem_tpu_torch.core.engine import BioEMEngine  # noqa: E402
from bioem_tpu_torch.core.orientations import rotation_matrices  # noqa: E402
from bioem_tpu_torch.core.projection import (  # noqa: E402
    _snap,
    lattice_axes,
    lattice_field,
)
from bioem_tpu_torch.io.model_io import Model, voxel_model  # noqa: E402
from bioem_tpu_torch.ops.project_cuda import (  # noqa: E402
    RASTER_LATTICE_MARGIN,
    RASTER_LATTICE_TILE,
)
from bioem_tpu_torch.rank import common_model_layout  # noqa: E402
from bioem_tpu_torch.tools.kernel_probe import lattice_angles, synthetic_map  # noqa: E402
from bioem_tpu_torch.utils.so3 import super_fibonacci  # noqa: E402
from bioem_tpu_torch.utils.timestat import RECORDER  # noqa: E402

from .conftest import tiny_images, tiny_model, tiny_params  # noqa: E402

PIX = 1.06
F = np.float32


def _map(shape=(12, 10, 9), seed=2):
    rng = np.random.default_rng(seed)
    return voxel_model(rng.uniform(0.5, 2.0, shape).astype(F), PIX).center_density_mass()


def _perturbed(m, seed=3):
    rng = np.random.default_rng(seed)
    return Model((m.points + rng.normal(0, 2.0, m.points.shape)).astype(F), m.radii, m.densities,
                 m.norm_den)


def _one_ulp(m):
    pts = m.points.copy()
    pts[17, 1] = np.nextafter(pts[17, 1], F(np.inf))
    return Model(pts, m.radii, m.densities, m.norm_den)


def _shuffled(m):
    perm = np.random.default_rng(4).permutation(m.n_points)
    return Model(m.points[perm], m.radii[perm], m.densities[perm], m.norm_den)


def _radius(m, r):
    return Model(m.points, np.full_like(m.radii, F(r)), m.densities, m.norm_den)


def _residues(_m):
    return tiny_model(np.random.default_rng(5), n_points=40)


NOT_LATTICES = {
    "perturbed": _perturbed,
    "shuffled": _shuffled,
    "one point moved one ulp": _one_ulp,
    "residue model": _residues,
    "point-like radius": lambda m: _radius(m, PIX),
    "radius past the kernel's reach": lambda m: _radius(m, 3.6 * PIX),
    "two radii": lambda m: Model(m.points, np.where(np.arange(m.n_points) % 2, m.radii,
                                                    m.radii * F(1.25)).astype(F),
                                 m.densities, m.norm_den),
}


@pytest.mark.parametrize("shape", [(12, 10, 9), (16, 16, 16), (2, 3, 2), (33, 40, 27)])
@pytest.mark.parametrize("centred", [False, True])
def test_voxel_map_is_a_lattice(shape, centred):
    """voxel_model's points (read as --ReadModelMRC reads a map), centred on
    the density mass or not, are a lattice: the axes and shape back, and the
    points their C-order broadcast."""
    vol = np.random.default_rng(1).uniform(0.5, 2.0, shape).astype(F)
    m = voxel_model(vol, PIX)
    if centred:
        m = m.center_density_mass()
    found = lattice_axes(m.points, m.radii, PIX)
    assert found is not None and found[1] == shape
    x, y, z = found[0]
    grid = np.stack(np.broadcast_arrays(x[:, None, None], y[None, :, None], z[None, None, :]),
                    -1).reshape(-1, 3)
    np.testing.assert_array_equal(grid.view(np.uint32), m.points.view(np.uint32))


@pytest.mark.parametrize("case", sorted(NOT_LATTICES))
def test_not_lattices(case):
    """A perturbed map, a shuffled map, a map with one point moved by one ulp,
    a residue model, a point-like radius, a radius past the lattice kernel's
    reach and a map of two radii are not lattices."""
    m = NOT_LATTICES[case](_map())
    assert lattice_axes(m.points, m.radii, PIX) is None


def test_unevenly_spaced_axis_is_not_a_lattice():
    """A C-order broadcast whose z axis is not evenly spaced (one coordinate
    a tenth of a pixel off) is not a lattice the kernel's fit can walk."""
    x = (np.arange(6) * PIX).astype(F)
    z = (np.arange(5) * PIX).astype(F)
    z[2] += F(0.1 * PIX)
    pts = np.stack(np.broadcast_arrays(x[:, None, None], x[None, :, None], z[None, None, :]),
                   -1).reshape(-1, 3).astype(F)
    radii = np.full(pts.shape[0], F(2 * PIX))
    assert lattice_axes(pts, radii, PIX) is None
    z[2] -= F(0.1 * PIX)
    pts[:, 2] = np.broadcast_to(z, (36, 5)).reshape(-1)
    assert lattice_axes(pts, radii, PIX) is not None


def _problem(n_pix=16):
    p = tiny_params(pixel_size=PIX, n_pixels=n_pix)
    from bioem_tpu_torch.core.orientations import build_orientations

    return p, build_orientations(p), tiny_images(np.random.default_rng(6), 2, n_pix)


def test_common_layout_takes_the_lattice_only_for_lattices_of_one_shape():
    """rank.common_model_layout: two maps of one shape keep the lattice
    variant; a map beside its perturbed copy, or beside a map of another
    shape, takes the generic walk."""
    p = tiny_params(pixel_size=PIX)
    m = _map()
    assert common_model_layout(p, [m, _map(seed=9)], "raster")["lattice"] is True
    assert common_model_layout(p, [m, _perturbed(m)], "raster")["lattice"] is False
    assert common_model_layout(p, [m, _map((12, 10, 8))], "raster")["lattice"] is False


def test_engine_counts_and_refuses_swaps_off_its_lattice():
    """The engine lays a map out on the lattice variant (counter
    ``bioem.projection.raster.lattice``, one per model laid out) and swaps
    in another map of its shape; a perturbed map or a map of another shape
    is refused with a clear error; an engine built on the common layout of
    a map and its perturbed copy takes the generic walk and swaps both."""
    p, orients, images = _problem()
    m = _map()
    cfg = RunConfig(projection="raster")
    before = RECORDER.count("bioem.projection.raster.lattice")
    eng = BioEMEngine(p, orients, m, images, cfg, device="cpu")
    assert eng.lattice == ((12, 10, 9), float(F(2 * PIX)))
    assert eng.banks.axes.shape == (32,)
    other = _map(seed=8)
    banks = eng.swap_model(other)
    np.testing.assert_array_equal(banks.axes.numpy(), lattice_field(
        lattice_axes(other.points, other.radii, PIX)[0], other.densities))
    assert banks.axes[-1] == float(np.abs(other.densities).max())
    assert RECORDER.count("bioem.projection.raster.lattice") == before + 2
    for bad, what in ((_perturbed(m), "not a voxel lattice"),
                      (_map((12, 10, 8)), r"a lattice of shape \(12, 10, 8\)")):
        with pytest.raises(ValueError, match=what):
            eng.swap_model(bad)
    pair = [m, _perturbed(m)]
    gen = BioEMEngine(p, orients, m, images, cfg, device="cpu",
                      model_layout=common_model_layout(p, pair, "raster"))
    assert gen.lattice is None and gen.banks.axes.numel() == 0
    assert gen.swap_model(pair[1]).axes.numel() == 0


def test_lattice_engine_pass_equals_the_generic_engine_on_the_cpu():
    """On the CPU both variants run the plain version: the lattice engine's
    pass is bit-equal to the generic engine's on the same map."""
    p, orients, images = _problem()
    m = _map()
    cfg = RunConfig(projection="raster", use_kernels=True)
    a = BioEMEngine(p, orients, m, images, cfg, device="cpu")
    b = BioEMEngine(p, orients, m, images, cfg, device="cpu", model_layout={"lattice": False})
    assert a.lattice is not None and b.lattice is None
    ra, rb = a.results(a.run()), b.results(b.run())
    np.testing.assert_array_equal(ra.log_prob, rb.log_prob)


# ---------------------------------------------------------------------------
# The twin of the kernel's walk
# ---------------------------------------------------------------------------

def _geometry(R, axes, n, pix, shift):
    """The kernel's per-orientation set-up, in float32 in its order: the
    plane axis a and in-plane axes b < c, and the fit's gradients, origin
    and inverse."""
    inv_pix = F(1) / F(pix)
    half = F(n) * F(0.5)
    h, c0, gi, gj = [], [], [], []
    a, best = 0, F(-1)
    for d, ax in enumerate(axes):
        c0.append(ax[0])
        h.append((ax[-1] - ax[0]) / F(ax.size - 1))
        gi.append((R[0, d] * h[d]) * inv_pix)
        gj.append((R[1, d] * h[d]) * inv_pix)
        score = np.abs(R[2, d]) / np.abs(h[d])
        if score > best:
            best, a = score, d
    b, c = (1 if a == 0 else 0), (1 if a == 2 else 2)

    def t0(row, s):
        dot = (R[row, 0] * c0[0] + R[row, 1] * c0[1]) + R[row, 2] * c0[2]
        return ((dot * inv_pix + half) + F(0.5)) - F(s)

    det = gi[b] * gj[c] - gi[c] * gj[b]
    m = (gj[c] / det, -gi[c] / det)
    return dict(a=a, b=b, c=c, gi=gi, gj=gj, ti0=t0(0, shift[0]), tj0=t0(1, shift[1]), m=m)


def _walk_holds(g, shape, k, u, v, r0, c0, reach, tile=RASTER_LATTICE_TILE):
    """Whether the tile at (r0, c0) walks voxel (k, u, v) of the plane
    axis and the in-plane axes: its plane's rows [u0, u1] (the widened
    tile with the walk's margin, through the fit's inverse) hold u, and
    row u's columns (each of the fit's two coordinates within the same
    bounds) hold v."""
    margin = F(RASTER_LATTICE_MARGIN)
    nb, nc = shape[g["b"]], shape[g["c"]]
    gi, gj, m = g["gi"], g["gj"], g["m"]
    bi = g["ti0"] + gi[g["a"]] * k.astype(F)
    bj = g["tj0"] + gj[g["a"]] * k.astype(F)
    lo_i, hi_i = (r0 - reach).astype(F) - margin, (r0 + tile + reach).astype(F) + margin
    lo_j, hi_j = (c0 - reach).astype(F) - margin, (c0 + tile + reach).astype(F) + margin
    hu_t = (np.abs(m[0]) + np.abs(m[1])) * (F(0.5) * (hi_i - lo_i))
    di, dj = F(0.5) * (lo_i + hi_i) - bi, F(0.5) * (lo_j + hi_j) - bj
    uc = m[0] * di + m[1] * dj
    u0 = np.ceil(np.maximum(uc - hu_t, F(0))).astype(np.int64)
    u1 = np.floor(np.minimum(uc + hu_t, F(nb - 1))).astype(np.int64)
    ri, rj = bi + gi[g["b"]] * u.astype(F), bj + gj[g["b"]] * u.astype(F)
    vl, vh = np.zeros(u.shape, F), np.full(u.shape, F(nc - 1))
    held = (u >= u0) & (u <= u1)
    for gc, r, lo, hi in ((gi[g["c"]], ri, lo_i, hi_i), (gj[g["c"]], rj, lo_j, hi_j)):
        if np.abs(gc) > F(1e-6):
            x, y = (lo - r) * (F(1) / gc), (hi - r) * (F(1) / gc)
            vl, vh = np.maximum(vl, np.minimum(x, y)), np.minimum(vh, np.maximum(x, y))
        else:
            held &= (r >= lo) & (r <= hi)
    return held & (v >= np.ceil(vl)) & (v <= np.floor(vh))


def _twin_orientations():
    """~200 quaternion rows: lattice_angles (axis-aligned, 45°, a body
    diagonal, random q with their −q), the 24 rotations of the cube, 45°
    about each face diagonal, and the super-Fibonacci list's first 155."""
    rows = [lattice_angles(n_random=6)]
    h = np.sqrt(0.5)
    cube = [(0, 0, 0, 1), (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0)]
    cube += [(s * h, 0, 0, h) for s in (1, -1)] + [(0, s * h, 0, h) for s in (1, -1)]
    cube += [(0, 0, s * h, h) for s in (1, -1)]
    cube += [(h, h, 0, 0), (h, -h, 0, 0), (h, 0, h, 0), (h, 0, -h, 0), (0, h, h, 0),
             (0, h, -h, 0)]
    cube += [(0.5 * a, 0.5 * b, 0.5 * c, 0.5) for a in (1, -1) for b in (1, -1)
             for c in (1, -1)]
    rows.append(np.asarray(cube, np.float64))
    s8 = np.sin(np.pi / 8)
    rows.append(np.asarray([(s8 * x / np.sqrt(2), s8 * y / np.sqrt(2), s8 * z / np.sqrt(2),
                             np.cos(np.pi / 8))
                            for x, y, z in ((1, 1, 0), (1, 0, 1), (0, 1, 1))]))
    rows.append(super_fibonacci(155))
    return np.concatenate(rows).astype(F)


@pytest.mark.parametrize("shift", [(0, 0), (2, -3)])
def test_twin_walk_holds_every_in_frame_voxel(shift):
    """The twin of the lattice kernel's walk on a 48³ map at N = 48 over
    ~200 orientations (_twin_orientations): every voxel whose snap (the
    plain version's) lies in the frame is walked by every tile whose
    widened tile holds its pixel, and owned by exactly one tile; the fit
    within 1/64 of the walk's one-pixel margin of the exact pre-floor
    coordinate (float64), so that no snap within ulps of a tie is missed."""
    n, reach, tile = 48, 1, RASTER_LATTICE_TILE
    model = synthetic_map(n, PIX)
    axes, shape = lattice_axes(model.points, model.radii, PIX)
    ang = _twin_orientations()
    assert ang.shape[0] >= 200
    rot = rotation_matrices(torch.as_tensor(ang), True)
    i0, j0, _small, _valid = _snap(n, PIX, shift[0], shift[1], rot,
                                   torch.as_tensor(model.points), torch.as_tensor(model.radii))
    idx = np.stack(np.unravel_index(np.arange(model.n_points), shape), 0)
    p64 = model.points.astype(np.float64)
    n_tiles = -(-n // tile)
    worst = 0.0
    for o in range(ang.shape[0]):
        R = rot[o].numpy()
        g = _geometry(R, axes, n, PIX, shift)
        qi, qj = i0[o].numpy().astype(np.int64), j0[o].numpy().astype(np.int64)
        live = (qi >= 0) & (qj >= 0) & (qi < n) & (qj < n)
        qi, qj = qi[live], qj[live]
        k, u, v = idx[g["a"]][live], idx[g["b"]][live], idx[g["c"]][live]
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                r0, c0 = (qi // tile + dr) * tile, (qj // tile + dc) * tile
                widened = ((r0 >= 0) & (c0 >= 0) & (r0 < n) & (c0 < n)
                           & (qi >= r0 - reach) & (qi < r0 + tile + reach)
                           & (qj >= c0 - reach) & (qj < c0 + tile + reach))
                held = _walk_holds(g, shape, k, u, v, r0, c0, reach, tile)
                assert (held | ~widened).all(), (o, dr, dc, int((widened & ~held).sum()))
        exact = p64[live] @ R.astype(np.float64)[:2].T / float(F(PIX)) + n / 2.0 + 0.5
        fit_i = (g["ti0"] + g["gi"][g["a"]] * k.astype(F)) + g["gi"][g["b"]] * u.astype(F) \
            + g["gi"][g["c"]] * v.astype(F)
        fit_j = (g["tj0"] + g["gj"][g["a"]] * k.astype(F)) + g["gj"][g["b"]] * u.astype(F) \
            + g["gj"][g["c"]] * v.astype(F)
        off = np.maximum(np.abs(fit_i - (exact[:, 0] - shift[0])),
                         np.abs(fit_j - (exact[:, 1] - shift[1])))
        worst = max(worst, float(off.max()))
        rows_hit = (qi[:, None] // tile == np.arange(n_tiles)[None, :]).sum(1)
        cols_hit = (qj[:, None] // tile == np.arange(n_tiles)[None, :]).sum(1)
        assert (rows_hit * cols_hit == 1).all()
    assert worst <= RASTER_LATTICE_MARGIN / 64, worst
