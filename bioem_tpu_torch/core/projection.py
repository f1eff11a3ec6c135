"""Model projection: rotate a point/sphere cloud and project it onto the grid.

PyTorch counterpart of ``bioem_tpu.core.projection`` (reference
``createProjection``, bioem.cpp:1604-1853). Two paths:

* **Fourier** (models with ≤ 32 distinct radii): every point deposits a
  fixed integer stencil (depending only on its radius) at integer pixel
  (i0, j0), so the projection's rfft2 is

      proj_f[k1, k2] = (NormDen/tempden) · Σ_r Ŝ_r[k1, k2] ⊙
                       Σ_{p∈r} dens_p · e^{−2πi(k1·i0_p + k2·j0_p)/N}

  with Ŝ_r the host-precomputed DFT of radius group r's unit stencil. The
  plain version evaluates the phases with cos/sin like the JAX package's
  XLA path; the kernel version (ops/project_cuda.py) takes the integer
  pixel positions and reads an exact twiddle table.
* **Raster** (continuous radii, or many points): per-point stencils
  scattered with ``index_add_``, then ``torch.fft.rfft2``; the kernel
  version (ops/project_cuda.raster_project) deposits them in model order
  without atomics, from the block's angle rows.

:func:`choose_projection` picks the path for a model (or the models that
share one engine) from the counted cost of each.

Semantics preserved exactly (both paths):
* radius ≤ pixelSize → single-pixel splat of the point density, no model
  shift applied (bioem.cpp:1715-1741);
* radius > pixelSize → solid-sphere chord-length density
  pix²·2·√(r²−d²)·ρ·3/(4πr·r²) over the disc d² < r², with the
  (shift_x, shift_y) offset and the per-point out-of-bounds skip
  (bioem.cpp:1744-1803);
* total density renormalised to the model's NormDen (bioem.cpp:1806-1818).

Rotations are full f32 (TF32 is off on CUDA, see core/engine.py): a
reduced-precision coordinate flips pixel snaps wholesale.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

F32 = torch.float32


@dataclass(frozen=True)
class ProjectionSpec:
    """Static projection configuration derived from the model + params."""

    n_pixels: int
    pixel_size: float
    shift_x: int
    shift_y: int
    stencil_half: int  # max irad over model points (0 if all point-like)


def make_projection_spec(p, radii: np.ndarray, stencil_half_min: int = 0) -> ProjectionSpec:
    """``stencil_half_min`` pads the stencil so one engine serves several
    models (multi-model ranking swaps model banks; the extra stencil rows
    carry zero weight)."""
    large = radii > p.pixel_size
    if large.any():
        irad_max = int(np.max((radii[large] / p.pixel_size).astype(np.int64)) + 1)
    else:
        irad_max = 0
    return ProjectionSpec(
        n_pixels=p.n_pixels,
        pixel_size=p.pixel_size,
        shift_x=p.shift_x,
        shift_y=p.shift_y,
        stencil_half=max(irad_max, stencil_half_min),
    )


def _rotate(points: torch.Tensor, rotmat: torch.Tensor) -> torch.Tensor:
    """r' = R @ r for every point: (..., 3, 3) × (P, 3) → (..., P, 3)."""
    return torch.matmul(points, rotmat.transpose(-1, -2))


def _snap(n: int, pix: float, shift_x: int, shift_y: int, rotmat, points, radii):
    """Pixel snap + bounds masks shared by both paths (bioem.cpp:1715-1803).
    Returns (i0, j0, small, valid) with leading dims of ``rotmat``."""
    rot = _rotate(points, rotmat)
    x, y = rot[..., 0], rot[..., 1]
    pix32 = float(np.float32(pix))
    half = float(n) / 2.0
    i_raw = torch.floor(x / pix32 + half + 0.5).to(torch.int32)
    j_raw = torch.floor(y / pix32 + half + 0.5).to(torch.int32)
    small = radii <= pix32
    irad = (radii / pix32).to(torch.int32) + 1
    i0 = torch.where(small, i_raw, i_raw - shift_x)
    j0 = torch.where(small, j_raw, j_raw - shift_y)
    valid_small = (i_raw >= 0) & (j_raw >= 0) & (i_raw < n) & (j_raw < n)
    valid_large = (i0 >= irad) & (j0 >= irad) & (i0 < n - irad) & (j0 < n - irad)
    valid = torch.where(small, valid_small, valid_large)
    return i0, j0, small, valid


def _stencil_weights(spec: ProjectionSpec, rotmat, points, radii, densities):
    """Per-point footprint: base pixel (i0, j0) and (S, S) weight patch,
    batched over the leading dims of ``rotmat``.

    Returns (i0, j0, w, du) with w already masked for chord condition,
    branch selection (point vs sphere) and the reference's bounds checks.
    """
    pix = float(np.float32(spec.pixel_size))
    s = spec.stencil_half
    i0, j0, small, valid = _snap(
        spec.n_pixels, spec.pixel_size, spec.shift_x, spec.shift_y,
        rotmat, points, radii,
    )
    dev = points.device
    if s == 0:
        w = torch.where(valid & small, densities, torch.zeros((), dtype=F32, device=dev))
        return i0, j0, w[..., None, None], torch.zeros(1, dtype=torch.int32, device=dev)

    du = torch.arange(-s, s + 1, dtype=torch.int32, device=dev)
    DU, DV = torch.meshgrid(du, du, indexing="ij")  # (S, S)
    dist = (DU * DU + DV * DV).to(F32)[None] * pix * pix  # (1,S,S)
    rad2 = radii * radii
    rad2b = rad2[:, None, None]
    inside = dist < rad2b
    chord = (
        pix
        * pix
        * 2.0
        * torch.sqrt(torch.clamp(rad2b - dist, min=0.0))
        * densities[:, None, None]
        * 3.0
        / (4.0 * float(np.float32(math.pi)) * radii[:, None, None] * rad2b)
    )
    center = (DU == 0) & (DV == 0)
    zero = torch.zeros((), dtype=F32, device=dev)
    w_large = torch.where(inside, chord, zero)
    w_small = torch.where(center[None], densities[:, None, None], zero)
    w = torch.where(small[:, None, None], w_small, w_large)  # (P, S, S)
    w = torch.where(valid[..., None, None], w, zero)  # (..., P, S, S)
    return i0, j0, w, du


def _raster_scatter(spec: ProjectionSpec, i0, j0, w, du):
    """Scatter-add of the weight patches into (..., N, N) projections."""
    n = spec.n_pixels
    lead = i0.shape[:-1]
    if spec.stencil_half == 0:
        ii = i0[..., None, None]
        jj = j0[..., None, None]
    else:
        DU, DV = torch.meshgrid(du, du, indexing="ij")
        ii = i0[..., None, None] + DU
        jj = j0[..., None, None] + DV
    flat = torch.clamp(ii * n + jj, 0, n * n - 1).long()  # (..., P, S, S)
    nb = int(np.prod(lead)) if lead else 1
    flat = flat.reshape(nb, -1) + (torch.arange(nb, device=flat.device) * (n * n))[:, None]
    proj = torch.zeros(nb * n * n, dtype=F32, device=w.device)
    proj.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return proj.reshape(*lead, n, n)


def project_batch(
    spec: ProjectionSpec,
    rotmats: torch.Tensor,  # (O, 3, 3)
    points: torch.Tensor,  # (P, 3) f32
    radii: torch.Tensor,  # (P,) f32
    densities: torch.Tensor,  # (P,) f32
    norm_den: torch.Tensor,  # scalar f32
) -> torch.Tensor:
    """(O, N, N) float32 projections for a block of orientations."""
    i0, j0, w, du = _stencil_weights(spec, rotmats, points, radii, densities)
    tempden = torch.sum(w, dim=(-3, -2, -1))  # (O,)
    proj = _raster_scatter(spec, i0, j0, w, du)
    return proj * (norm_den / tempden)[:, None, None]


def project_batch_kernel(spec, angles, points, radii, densities, norm_den, *,
                         use_quaternions: bool, lattice=None):
    """Same contract as project_batch, from the block's orientation rows
    ``angles`` (O, 4), through G4 (ops/project_cuda.raster_project): the
    rotation matrices, the snap, the stencil weights, their deposit and
    the scale norm_den/tempden on the card. ``lattice``, (axes, shape,
    radius) of a voxel lattice (:func:`lattice_axes`), takes its lattice
    kernel; else the generic walk over the point list."""
    from ..ops.project_cuda import raster_project

    return raster_project(spec, angles, points, radii, densities, norm_den,
                          use_quaternions=use_quaternions, lattice=lattice)


# ---------------------------------------------------------------------------
# Fourier-space projection (radius-grouped)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FourierProjectionSpec:
    n_pixels: int
    pixel_size: float
    shift_x: int
    shift_y: int
    n_groups: int  # radius groups G (possibly padded, see n_groups_pad)
    group_pad: int  # points per group after padding (Pp)
    # Model points in each group: its first slots, the padding after them.
    # Model data, not layout: two models on one layout may differ here, so
    # it takes no part in the spec's equality (the engine carries it per
    # model as Banks.counts).
    group_counts: tuple[int, ...] = field(compare=False)


MAX_RADIUS_GROUPS = 32

# The path rule's constants: seconds per orientation of each path on one
# H100 (NVIDIA H100 80GB HBM3, 700 W), from the card's own time of a block
# of 8 orientations of the BioEM manual's grid at N = 224, G3 + K2 against
# G4 + rfft2, for 500 to 11.2 M points of one radius
# (tools/kernel_probe.path_rule_times). The Fourier path costs FOURIER_S0 +
# FOURIER_S_SLOT_FREQ per (group slot, frequency) (K2's group product:
# G·Pp slots times N·F frequencies; fitted at 5,000 and 500,000 slots, within
# 7 % of the four other readings); the raster RASTER_S0 + RASTER_S_PIXEL per
# pixel of the frame (rfft2) + RASTER_S_POINT per point (the snaps, the bins,
# the deposit; the slope between 5,000 and 50,000 points, the steepest
# measured: 4.8x the 11.2 M-point reading).
FOURIER_S0 = 1.3e-6
FOURIER_S_SLOT_FREQ = 2.27e-13
RASTER_S0 = 2.85e-6
RASTER_S_PIXEL = 2.8e-11
RASTER_S_POINT = 2.86e-10
# The raster takes over only where the Fourier path counts this many times
# more (one radius at N = 224: from ~3,400 points): near the measured
# crossover (~500 points) both cost well under 1 % of a pass, and a model
# that ran on the Fourier path keeps its results.
RASTER_MARGIN = 4.0


def _radius_groups(radii: np.ndarray) -> tuple:
    """(distinct radii, largest group) of a model's radii as float32; one
    pass where every radius is the same (a voxel map)."""
    r = np.asarray(radii, np.float32)
    if r.size == 0 or bool((r == r[0]).all()):
        return 1, int(r.size)
    _uniq, counts = np.unique(r, return_counts=True)
    return int(counts.size), int(counts.max())


def choose_projection(p, models, projection: str = "auto") -> str:
    """The projection path, ``"fourier"`` or ``"raster"``, of the models
    that share one engine (one engine runs one path). ``projection``
    "raster" forces the raster; "fourier" forces the Fourier path, which
    needs ≤ MAX_RADIUS_GROUPS distinct radii in every model; "auto" takes
    the raster for a model of more distinct radii, and otherwise where
    the Fourier path's counted cost per orientation (on the layout the
    models would share: G groups of Pp slots) is more than RASTER_MARGIN
    times the raster's (the constants above)."""
    if projection == "raster":
        return "raster"
    if projection not in ("auto", "fourier"):
        raise ValueError(f"projection must be auto, fourier or raster, got {projection!r}")
    g_max = pp_max = p_max = 0
    for m in models:
        g, largest = _radius_groups(m.radii)
        if g > MAX_RADIUS_GROUPS:
            if projection == "fourier":
                raise ValueError(f"projection='fourier' requires <= {MAX_RADIUS_GROUPS} "
                                 f"distinct radii (a model has {g})")
            return "raster"
        g_max, pp_max = max(g_max, g), max(pp_max, -(-largest // 8) * 8)
        p_max = max(p_max, int(np.asarray(m.radii).size))
    if projection == "fourier":
        return "fourier"
    n = p.n_pixels
    fourier = FOURIER_S0 + FOURIER_S_SLOT_FREQ * g_max * pp_max * n * (n // 2 + 1)
    raster = RASTER_S0 + RASTER_S_PIXEL * n * n + RASTER_S_POINT * p_max
    return "raster" if fourier > RASTER_MARGIN * raster else "fourier"


# The largest radius, in pixels, of a lattice the raster's lattice kernel
# takes (ops/project_cuda.raster_project): its reach (the largest b with
# (b + 1)²·pix² < r²) is then at most 3, the kernel's widest instance.
LATTICE_MAX_RADIUS_PIX = 3.5
# How far, in pixels, an axis's coordinates may stray from its evenly
# spaced fit: the lattice kernel finds the voxels near a tile from that fit
# and then snaps each on its own coordinates, so the fit only has to stay
# well inside the error the kernel allows for (1/16 of a pixel).
LATTICE_SPACING_TOL_PIX = 1e-3
# The steps, in pixels, of a lattice the kernel takes (a voxel map's step
# is the pixel size): within them a plane's rows around a tile fit the
# kernel's table (csrc/project_raster.cu kLMaxRows).
LATTICE_STEP_PIX = (0.8, 1.25)


def _run_length(same: np.ndarray) -> int:
    """Leading True entries of ``same``."""
    off = np.flatnonzero(~same)
    return int(off[0]) if off.size else int(same.size)


def lattice_axes(points, radii, pixel_size: float):
    """``((x, y, z), (nx, ny, nz))`` — the three axis coordinate vectors
    (float32) and the shape — where the model's points are a voxel lattice,
    as io.model_io.voxel_model lays a map out; else None. It reads the
    points and radii alone and holds them to all of:

    * P = nx·ny·nz points, each axis of at least 2 coordinates;
    * the points are the C-order broadcast of (x, y, z), bit for bit
      (point (i, j, k) at index (i·ny + j)·nz + k);
    * each axis is evenly spaced, to LATTICE_SPACING_TOL_PIX of a pixel,
      its step within LATTICE_STEP_PIX pixels (increasing or decreasing);
    * every radius is the same, not point-like (> pixel_size) and at most
      LATTICE_MAX_RADIUS_PIX pixels.

    The raster's lattice kernel projects such a model by walking its
    planes (ops/project_cuda.raster_project); anything else takes the
    generic walk over the point list. Padding points (rank's layouts)
    come after the model's and are not read here."""
    pts = np.ascontiguousarray(points, np.float32)
    r = np.asarray(radii, np.float32).reshape(-1)
    pix = np.float32(pixel_size)
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] < 8 or r.size != pts.shape[0]:
        return None
    r0 = r[0]
    if not (pix < r0 <= np.float32(LATTICE_MAX_RADIUS_PIX) * pix):
        return None
    if not (r.view(np.uint32) == r0.view(np.uint32)).all():
        return None
    bits = pts.view(np.uint32)
    nz = _run_length((bits[:, 0] == bits[0, 0]) & (bits[:, 1] == bits[0, 1]))
    nyz = _run_length(bits[:, 0] == bits[0, 0])
    n_p = pts.shape[0]
    if nz < 2 or nyz % nz or nyz // nz < 2 or n_p % nyz or n_p // nyz < 2:
        return None
    ny, nx = nyz // nz, n_p // nyz
    axes = (pts[::nyz, 0].copy(), pts[:nyz:nz, 1].copy(), pts[:nz, 2].copy())
    grid = bits.reshape(nx, ny, nz, 3)
    for d, a in enumerate(axes):
        shape = [1, 1, 1]
        shape[d] = a.size
        if not (grid[..., d] == a.view(np.uint32).reshape(shape)).all():
            return None
        a64 = a.astype(np.float64)
        step = (a64[-1] - a64[0]) / (a.size - 1)
        fit = a64[0] + np.arange(a.size) * step
        lo, hi = LATTICE_STEP_PIX
        if not (lo * pix <= abs(step) <= hi * pix
                and np.abs(a64 - fit).max() <= LATTICE_SPACING_TOL_PIX * pix):
            return None
    return axes, (nx, ny, nz)


def lattice_field(axes, densities) -> np.ndarray:
    """What G4's lattice variant reads of a lattice model (the engine's
    Banks.axes): its axes (:func:`lattice_axes`) x, y, z, then its largest
    |density| (which sets the kernel's fixed point), (nx + ny + nz + 1,)
    float32."""
    dmax = np.abs(np.asarray(densities, np.float32)).max(initial=np.float32(0))
    return np.concatenate([*axes, [dmax]]).astype(np.float32)


def _unit_stencil(radius: float, pix: float) -> np.ndarray:
    """Unit-density footprint of one sphere (reference bioem.cpp:1744-1803)."""
    if radius <= pix:
        return np.ones((1, 1), np.float64)
    irad = int(radius / pix) + 1
    du = np.arange(-irad, irad + 1)
    dist = (du[:, None] ** 2 + du[None, :] ** 2).astype(np.float64) * pix * pix
    rad2 = float(radius) ** 2
    chord = pix * pix * 2.0 * np.sqrt(np.maximum(rad2 - dist, 0.0)) * 3.0 / (
        4.0 * math.pi * radius * rad2
    )
    return np.where(dist < rad2, chord, 0.0)


def make_fourier_projection_spec(
    p, radii: np.ndarray, n_groups_pad: int = 0, group_pad: int = 0
):
    """(spec, gather_idx, pad_mask, stencil_dfts, stencil_sums) or None if
    too many radius groups (host NumPy, a copy of the JAX package's).

    ``gather_idx`` is a (G·Pp,) index into the model arrays laying points out
    as G uniform radius groups of Pp slots (groups padded with repeats of
    their first member — the engine zeroes the padding densities via
    ``pad_mask``); ``stencil_dfts`` is (G, N, F) complex64 and
    ``stencil_sums`` (G,) float32 (Σ of each group's unit-density stencil,
    feeding tempden).

    ``n_groups_pad``/``group_pad`` pad the layout to a common shape so one
    engine can serve several models (padded groups carry zero stencils,
    zero-density points and a zero count).
    """
    uniq, inverse = np.unique(np.asarray(radii, np.float32), return_inverse=True)
    if uniq.size > max(MAX_RADIUS_GROUPS, n_groups_pad):
        return None
    n, nf = p.n_pixels, p.n_fft_1d
    groups = [np.nonzero(inverse == g)[0] for g in range(uniq.size)]
    g_out = max(uniq.size, n_groups_pad)
    pp = max(len(m) for m in groups)
    pp = max(((pp + 7) // 8) * 8, group_pad)
    gather_idx = np.zeros(g_out * pp, np.int64)
    pad_mask = np.zeros(g_out * pp, np.float32)
    dfts = [np.zeros((n, nf), np.complex64)] * g_out
    sums = np.zeros(g_out, np.float32)
    for g, members in enumerate(groups):
        gather_idx[g * pp: g * pp + len(members)] = members
        gather_idx[g * pp + len(members): (g + 1) * pp] = members[0]
        pad_mask[g * pp: g * pp + len(members)] = 1.0
        st = _unit_stencil(float(uniq[g]), p.pixel_size)
        s_half = st.shape[0] // 2
        du = np.arange(-s_half, s_half + 1)
        k1 = np.arange(n)[:, None]
        k2 = np.arange(nf)[None, :]
        phx = np.exp(-2j * np.pi * np.outer(k1.ravel(), du) / n)  # (N, S)
        phy = np.exp(-2j * np.pi * np.outer(k2.ravel(), du) / n)  # (F, S)
        dfts[g] = np.matmul(
            np.matmul(phx, st.astype(np.complex128)), phy.T
        ).astype(np.complex64)
        sums[g] = st.sum()
    spec = FourierProjectionSpec(
        n_pixels=n,
        pixel_size=p.pixel_size,
        shift_x=p.shift_x,
        shift_y=p.shift_y,
        n_groups=g_out,
        group_pad=pp,
        group_counts=tuple(len(m) for m in groups) + (0,) * (g_out - uniq.size),
    )
    return spec, gather_idx, pad_mask, np.stack(dfts), sums


def fourier_snap(fspec: FourierProjectionSpec, rotmat, points, radii, densities):
    """Integer pixel positions (i0, j0) and bounds-masked densities,
    batched over the leading dims of ``rotmat`` — the input of the
    projection kernel."""
    i0, j0, _small, valid = _snap(
        fspec.n_pixels, fspec.pixel_size, fspec.shift_x, fspec.shift_y,
        rotmat, points, radii,
    )
    dens_eff = torch.where(valid, densities, torch.zeros((), dtype=F32, device=densities.device))
    return i0, j0, dens_eff


def fourier_prologue(fspec: FourierProjectionSpec, rotmat, points, radii, densities):
    """Rotation + pixel snap + validity masking. Returns (θx, θy, dens_eff),
    each (..., P): phase increments −2π·i0/N, −2π·j0/N and the
    bounds-masked densities (reference bioem.cpp:1715-1803 semantics)."""
    i0, j0, dens_eff = fourier_snap(fspec, rotmat, points, radii, densities)
    two_pi_n = float(np.float32(2.0 * math.pi / fspec.n_pixels))
    theta_x = -two_pi_n * i0.to(F32)
    theta_y = -two_pi_n * j0.to(F32)
    return theta_x, theta_y, dens_eff


def fourier_epilogue(
    fspec: FourierProjectionSpec,
    theta_x: torch.Tensor,  # (..., P) per-point row phase increments
    theta_y: torch.Tensor,  # (..., P)
    dens_eff: torch.Tensor,  # (..., P) effective densities (padding zeroed)
    norm_den: torch.Tensor,
    st_re: torch.Tensor,
    st_im: torch.Tensor,
    st_sums: torch.Tensor,
    signed_rows: bool = False,
):
    """Radius-group contraction shared by the snapped (grid engine) and
    smooth (refine.py) prologues: spectrum = Σ_g stencilDFT_g ⊙
    Σ_p dens_p·e^{i(θx_p k1 + θy_p k2)}, density-renormalised.

    ``signed_rows``: row frequencies as signed integers (−N/2, N/2]. At the
    snapped path's integer pixel positions both conventions are identical
    (e^{iθk} is k-periodic mod N there), so the grid engine keeps the raw
    0..N−1 layout. The smooth path must use signed rows: with raw indices
    a fractional point position breaks the spectrum's Hermitian row
    symmetry and the surrogate posterior ripples at subpixel scale."""
    n = fspec.n_pixels
    nf = n // 2 + 1
    dev = theta_x.device
    if signed_rows:
        k1 = (torch.remainder(torch.arange(n, device=dev) + n // 2, n) - n // 2).to(F32)
    else:
        k1 = torch.arange(n, dtype=F32, device=dev)
    k2 = torch.arange(nf, dtype=F32, device=dev)
    ax = theta_x[..., :, None] * k1  # (..., P, N)
    ay = theta_y[..., :, None] * k2  # (..., P, F)
    ex_re = torch.cos(ax) * dens_eff[..., :, None]
    ex_im = torch.sin(ax) * dens_eff[..., :, None]
    ey_re, ey_im = torch.cos(ay), torch.sin(ay)

    g, pp = fspec.n_groups, fspec.group_pad
    lead = theta_x.shape[:-1]
    a = torch.cat(
        [ex_re.reshape(*lead, g, pp, n), ex_im.reshape(*lead, g, pp, n)], dim=-2
    )  # (..., G, 2Pp, N)
    eyr = ey_re.reshape(*lead, g, pp, nf)
    eyi = ey_im.reshape(*lead, g, pp, nf)
    b_re = torch.cat([eyr, -eyi], dim=-2)  # (..., G, 2Pp, F)
    b_im = torch.cat([eyi, eyr], dim=-2)
    s_re = torch.einsum("...gpn,...gpf->...gnf", a, b_re)
    s_im = torch.einsum("...gpn,...gpf->...gnf", a, b_im)
    proj_re = torch.sum(st_re * s_re - st_im * s_im, dim=-3)
    proj_im = torch.sum(st_re * s_im + st_im * s_re, dim=-3)

    group_dens = torch.sum(dens_eff.reshape(*lead, g, pp), dim=-1)  # (..., G)
    tempden = torch.matmul(group_dens, st_sums.to(F32))  # (...,)
    scale = (norm_den / tempden)[..., None, None]
    return proj_re * scale, proj_im * scale


def project_fourier_batch(
    fspec, rotmats, points, radii, densities, norm_den, st_re, st_im, st_sums
):
    """(O, N, F) split-complex rfft2 projections for an orientation block
    (plain torch: cos/sin phase tables and einsum group contractions)."""
    thx, thy, de = fourier_prologue(fspec, rotmats, points, radii, densities)
    return fourier_epilogue(fspec, thx, thy, de, norm_den, st_re, st_im, st_sums)


def grouped_snap(fspec: FourierProjectionSpec, rotmats, points, radii, densities):
    """The projection kernel's inputs for an orientation block: integer
    pixel positions and masked densities, each (G, O, Pp)."""
    g, pp = fspec.n_groups, fspec.group_pad
    o_n = rotmats.shape[0]
    return tuple(
        x.reshape(o_n, g, pp).permute(1, 0, 2).contiguous()
        for x in fourier_snap(fspec, rotmats, points, radii, densities)
    )


def project_fourier_batch_kernel(
    fspec, angles, points, radii, densities, norm_den, st_re, st_im, st_sums,
    counts=None, *, use_quaternions: bool,
):
    """Same contract as project_fourier_batch, from the block's orientation
    rows ``angles`` (O, 4), through two kernels (ops/project_cuda.py): G3,
    the prologue (rotation matrices, the pixel snap and its bounds masks,
    the (G, O, Pp) regroup and the scale norm_den/tempden), then the
    projection kernel (the counterpart of the JAX package's
    project_fourier_batch_pallas), which reads an exact N-entry twiddle
    table and, of each group, only the first ``counts[g]`` slots (not its
    padding), and stores its spectra times the scale. ``counts`` is the
    model's (G,) int32 tensor (the engine's Banks.counts); None reads the
    spec's ``group_counts``."""
    from ..ops.project_cuda import counts_tensor, fourier_project_block, project_prologue

    i0, j0, de, scale = project_prologue(fspec, angles, points, radii, densities, norm_den,
                                         st_sums, use_quaternions=use_quaternions)
    if counts is None:
        counts = counts_tensor(fspec.group_counts, de.device)
    return fourier_project_block(i0, j0, de, st_re, st_im, n=fspec.n_pixels, counts=counts,
                                 scale=scale)


# ---------------------------------------------------------------------------
# Out-of-bounds diagnostics (host NumPy, copies of the JAX package's;
# reference bioem.cpp:1723-1731 warns per projection when a point leaves
# the grid; a fully out-of-frame model gives tempden == 0 → NaN)
# ---------------------------------------------------------------------------


def projection_always_in_bounds(
    n: int, pix: float, shift_x: int, shift_y: int,
    points: np.ndarray, radii: np.ndarray,
) -> bool:
    """Rotation-invariant sufficient condition for "no point ever leaves the
    grid": the projected coordinate of a point is bounded by its 3D norm, so
    if every point's worst-case pixel index (incl. its sphere footprint and
    the SHIFT offsets) stays inside [0, N), no orientation can trigger the
    reference's out-of-bounds skip."""
    r3d = np.linalg.norm(np.asarray(points, np.float64), axis=1)
    radii = np.asarray(radii, np.float64)
    irad = np.where(radii > pix, (radii / pix).astype(np.int64) + 1, 0)
    shift = max(abs(int(shift_x)), abs(int(shift_y)))
    worst = r3d / pix + 0.5 + irad + shift
    return bool(np.all(worst < n / 2.0 - 1.0))


def projection_oob_report(
    n: int, pix: float, shift_x: int, shift_y: int,
    points: np.ndarray, radii: np.ndarray, rotmats: np.ndarray,
    chunk: int = 256,
):
    """Per-orientation out-of-frame census, mirroring the projection's
    validity mask exactly. Returns ``(total_oob_point_evals,
    n_orient_affected, n_orient_all_oob)``. Only points that can leave the
    grid at all are visited."""
    points = np.asarray(points, np.float32)
    radii = np.asarray(radii, np.float32)
    rotmats = np.asarray(rotmats, np.float32)
    n_points = points.shape[0]
    r3d = np.linalg.norm(points.astype(np.float64), axis=1)
    irad64 = np.where(radii > pix, (radii / pix).astype(np.int64) + 1, 0)
    shift = max(abs(int(shift_x)), abs(int(shift_y)))
    always_in = (r3d / pix + 0.5 + irad64 + shift) < (n / 2.0 - 1.0)
    n_safe = int(always_in.sum())
    if n_safe == n_points:
        return 0, 0, 0
    keep = ~always_in
    points = points[keep]
    radii = radii[keep]
    small = radii <= pix
    irad = (radii / pix).astype(np.int32) + 1
    half = np.float32(n) / 2.0
    total = 0
    affected = 0
    all_oob = 0
    for s in range(0, rotmats.shape[0], chunk):
        rm = rotmats[s:s + chunk]  # (B, 3, 3)
        rot = np.einsum("bij,pj->bpi", rm, points)
        x, y = rot[..., 0], rot[..., 1]
        i_raw = np.floor(x / pix + half + 0.5).astype(np.int32)
        j_raw = np.floor(y / pix + half + 0.5).astype(np.int32)
        i0 = np.where(small, i_raw, i_raw - shift_x)
        j0 = np.where(small, j_raw, j_raw - shift_y)
        valid_small = (i_raw >= 0) & (j_raw >= 0) & (i_raw < n) & (j_raw < n)
        valid_large = (
            (i0 >= irad) & (j0 >= irad) & (i0 < n - irad) & (j0 < n - irad)
        )
        valid = np.where(small, valid_small, valid_large)  # (B, P)
        oob = (~valid).sum(axis=1)
        total += int(oob.sum())
        affected += int((oob > 0).sum())
        if n_safe == 0:
            all_oob += int((oob == points.shape[0]).sum())
    return total, affected, all_oob


def oob_census(
    n: int, pix: float, shift_x: int, shift_y: int,
    points: np.ndarray, radii: np.ndarray, angles: np.ndarray, use_quaternions: bool,
    device=None,
):
    """The out-of-frame census of :func:`projection_oob_report` — ``(total
    oob point evaluations, orientations affected, orientations with every
    point out)`` — from the orientation rows ``angles`` (O, 4), on
    ``device``: on the card the snap kernel of G3 and G4
    (ops/project_cuda.bounds_census), each (orientation, point) once, which
    may count a pair at a snap's tie (within an ulp or two of a pixel edge)
    otherwise than NumPy's sums; on the CPU :func:`projection_oob_report` on
    torch's rotation matrices of the rows. Only points that can leave the
    frame at all (the rotation-invariant bound) are visited."""
    from .orientations import rotation_matrices

    dev = torch.device(device) if device is not None else torch.device("cpu")
    ang = torch.as_tensor(np.ascontiguousarray(angles, dtype=np.float32), device=dev)
    if dev.type != "cuda":
        return projection_oob_report(n, pix, shift_x, shift_y, points, radii,
                                     rotation_matrices(ang, use_quaternions).numpy())
    from ..ops.project_cuda import bounds_census

    points = np.asarray(points, np.float32)
    radii = np.asarray(radii, np.float32)
    r3d = np.linalg.norm(points.astype(np.float64), axis=1)
    irad = np.where(radii > pix, (radii / pix).astype(np.int64) + 1, 0)
    shift = max(abs(int(shift_x)), abs(int(shift_y)))
    keep = ~((r3d / pix + 0.5 + irad + shift) < (n / 2.0 - 1.0))
    n_left = int(keep.sum())
    if n_left == 0:
        return 0, 0, 0
    pts = torch.as_tensor(np.ascontiguousarray(points[keep]), device=dev)
    rad = torch.as_tensor(np.ascontiguousarray(radii[keep]), device=dev)
    oob = bounds_census(ang, pts, rad, n=n, pixel_size=pix, shift_x=shift_x, shift_y=shift_y,
                        use_quaternions=use_quaternions).cpu().numpy()
    all_oob = int((oob == n_left).sum()) if n_left == points.shape[0] else 0
    return int(oob.sum()), int((oob > 0).sum()), all_oob
