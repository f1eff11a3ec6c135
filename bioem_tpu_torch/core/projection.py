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
* **Raster** (continuous radii): per-point stencils scattered with
  ``index_add_``, then ``torch.fft.rfft2``.

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
from dataclasses import dataclass

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


def make_projection_spec(p, radii: np.ndarray) -> ProjectionSpec:
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
        stencil_half=irad_max,
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


# ---------------------------------------------------------------------------
# Fourier-space projection (radius-grouped)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FourierProjectionSpec:
    n_pixels: int
    pixel_size: float
    shift_x: int
    shift_y: int
    n_groups: int  # radius groups G
    group_pad: int  # points per group after padding (Pp)


MAX_RADIUS_GROUPS = 32


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


def make_fourier_projection_spec(p, radii: np.ndarray):
    """(spec, gather_idx, pad_mask, stencil_dfts, stencil_sums) or None if
    too many radius groups (host NumPy, a copy of the JAX package's).

    ``gather_idx`` is a (G·Pp,) index into the model arrays laying points out
    as G uniform radius groups of Pp slots (groups padded with repeats of
    their first member — the engine zeroes the padding densities via
    ``pad_mask``); ``stencil_dfts`` is (G, N, F) complex64 and
    ``stencil_sums`` (G,) float32 (Σ of each group's unit-density stencil,
    feeding tempden).
    """
    uniq, inverse = np.unique(np.asarray(radii, np.float32), return_inverse=True)
    if uniq.size > MAX_RADIUS_GROUPS:
        return None
    n, nf = p.n_pixels, p.n_fft_1d
    groups = [np.nonzero(inverse == g)[0] for g in range(uniq.size)]
    g_out = uniq.size
    pp = max(len(m) for m in groups)
    pp = ((pp + 7) // 8) * 8
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
):
    """Radius-group contraction: spectrum = Σ_g stencilDFT_g ⊙
    Σ_p dens_p·e^{i(θx_p k1 + θy_p k2)}, density-renormalised. Row
    frequencies are the raw 0..N−1 layout (the JAX package's
    ``signed_rows=False``: identical at integer pixel positions)."""
    n = fspec.n_pixels
    nf = n // 2 + 1
    dev = theta_x.device
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
    fspec, rotmats, points, radii, densities, norm_den, st_re, st_im, st_sums
):
    """Same contract as project_fourier_batch through the projection
    kernel (ops/project_cuda.py, the counterpart of the JAX package's
    project_fourier_batch_pallas): integer pixel positions go to the kernel,
    which reads an exact N-entry twiddle table; the caller-side scale
    norm_den/tempden is applied here."""
    from ..ops.project_cuda import fourier_project_block

    i0, j0, de = grouped_snap(fspec, rotmats, points, radii, densities)  # (G, O, Pp)
    pr, pi = fourier_project_block(i0, j0, de, st_re, st_im, n=fspec.n_pixels)
    tempden = torch.matmul(de.sum(dim=2).T, st_sums.to(F32))  # (O,)
    scale = (norm_den / tempden)[:, None, None]
    return pr * scale, pi * scale


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
