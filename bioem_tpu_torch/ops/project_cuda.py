"""The projection's CUDA kernel wrappers and their plain versions.

Three kernels, each beside the torch code it replaces as its plain version:

* K2 :func:`fourier_project_block` replaces
  ``bioem_tpu/ops/project_pallas.py:_project_kernel`` (entry
  ``fourier_project_block``); the kernel is ``csrc/project.cu``;
* G3 :func:`project_prologue`, the work XLA fused around that kernel on
  the TPU (no Pallas kernel has its body): the block's rotation matrices,
  the rotation, the pixel snap with its bounds masks, the regroup into
  K2's (G, O, Pp) layout and the scale norm_den/tempden
  (``bioem_tpu/core/orientations.py:138-202``,
  ``bioem_tpu/core/projection.py:302-330`` and ``:444-461``); the kernel
  is ``csrc/project_glue.cu``;
* G4 :func:`raster_project`, the raster path (core.projection
  .choose_projection: models with more than 32 distinct radii, models whose
  Fourier projection costs far more, or a layout that forces it), which XLA
  fused on the TPU (no Pallas kernel has its body): the block's rotation
  matrices, the snap, the stencil weights, their deposit and the scale
  norm_den/tempden (``bioem_tpu/core/projection.py:74-195``); the kernels
  are ``csrc/project_raster.cu``'s ``raster_projection_kernel_*``: for a
  voxel lattice (core.projection.lattice_axes) two launches that walk its
  planes per pixel tile, for any other point list six (the points bucketed
  by bin of the frame, then each bin deposited from its own bucket); and
  torch.fft.rfft2 transforms its output. The same source holds the out-of-frame census
  (:func:`bounds_census`), which core/engine.py runs at set-up on the card.

Each source's header says what bounds it on the card and how the design
answers that.

K2's contract (times ``scale[o]`` where a scale is given, else unscaled):

    out[o, k1, k2] = Σ_g Ŝ_g[k1, k2] · Σ_p dens[g,o,p] ·
                     e^{−2πi·(i0[g,o,p]·k1 + j0[g,o,p]·k2)/N}

The inputs are the integer snapped pixel positions of
core.projection.fourier_snap (the JAX kernel takes the phase increments
θ = −2π·i0/N instead; the integers make the phase an exact table entry).
``counts[g]`` (core.projection.FourierProjectionSpec.group_counts) is the
number of slots of group g that hold model points; the slots after it are
the group's padding and are not read (the plain version, given counts,
zeroes their density, so both keep one contract whatever the counts say).

A CPU tensor gets the plain torch version; a CUDA tensor gets the kernel
or an exception — never a fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.orientations import rotation_matrices
from ..core.projection import grouped_snap, project_batch
from . import _build

F32 = torch.float32

# The largest N the kernel takes (csrc/project.cu's kMaxN): its twiddle
# table, 8·N bytes, beside its four warpgroups' 49408 bytes of operand
# tiles, partial spectra and points in 227 KB of shared memory. The C entry
# bioem_fourier_project_max_n says the same (a card test compares them).
MAX_N = (227 * 1024 - 4 * 49408) // 8


def twiddles(n: int, device=None) -> torch.Tensor:
    """tw[j] = e^{−2πi·j/N}, complex64 rounded from float64."""
    ph = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return torch.as_tensor(np.exp(1j * ph).astype(np.complex64), device=device)


@functools.lru_cache(maxsize=16)
def counts_tensor(counts: tuple, device) -> torch.Tensor:
    """The (G,) int32 tensor of per-group point counts on ``device``,
    made once per spec and device."""
    return torch.tensor(counts, dtype=torch.int32, device=device)


def _live(dens, counts):
    """dens with the slots at or after counts[g] zeroed."""
    if counts is None:
        return dens
    slot = torch.arange(dens.shape[2], device=dens.device)
    return torch.where(slot < counts.to(dens.device).long()[:, None, None], dens,
                       torch.zeros((), dtype=dens.dtype, device=dens.device))


def fourier_project_block_plain(i0, j0, dens, st_re, st_im, *, n: int, counts=None,
                                scale=None):
    """Plain torch version: per-point phase tables read from the same
    twiddle table, then complex einsum group contractions; times ``scale``
    (O,) where given."""
    g_n, o_n, pp = i0.shape
    dens = _live(dens, counts)
    nf = n // 2 + 1
    dev = dens.device
    tw = twiddles(n, dev)
    k1 = torch.arange(n, device=dev, dtype=torch.int64)
    k2 = torch.arange(nf, device=dev, dtype=torch.int64)
    a = torch.remainder(i0.long(), n)[..., None]  # (G, O, Pp, 1)
    b = torch.remainder(j0.long(), n)[..., None]
    ex = tw[(a * k1) % n] * dens[..., None].to(torch.complex64)  # (G, O, Pp, N)
    ey = tw[(b * k2) % n]  # (G, O, Pp, F)
    s = torch.einsum("gopn,gopf->gonf", ex, ey)  # (G, O, N, F)
    st = torch.complex(st_re, st_im)[:, None]  # (G, 1, N, F)
    out = torch.sum(st * s, dim=0)  # (O, N, F)
    if scale is not None:
        return out.real * scale[:, None, None], out.imag * scale[:, None, None]
    return out.real.contiguous(), out.imag.contiguous()


def fourier_project_block(
    i0: torch.Tensor,  # (G, O, Pp) int32 — snapped row pixel per point
    j0: torch.Tensor,  # (G, O, Pp) int32 — snapped column pixel
    dens: torch.Tensor,  # (G, O, Pp) f32 — bounds-masked densities
    st_re: torch.Tensor,  # (G, N, F) f32 — stencil DFT bank
    st_im: torch.Tensor,
    *,
    n: int,
    counts: torch.Tensor,  # (G,) int32 — model points per group
    scale: torch.Tensor = None,  # (O,) f32 — norm_den/tempden, or None: unscaled
):
    """Projection spectra (O, N, F) ×2, times ``scale`` where given (see
    module docstring)."""
    if dens.device.type == "cpu":
        return fourier_project_block_plain(i0, j0, dens, st_re, st_im, n=n, counts=counts,
                                           scale=scale)
    if dens.device.type != "cuda":
        raise ValueError(f"fourier_project_block: unsupported device {dens.device}")
    g_n, o_n, pp = i0.shape
    nf = n // 2 + 1
    _build.check_tensors("fourier_project_block", dens.device, [
        ("counts", counts, torch.int32, (g_n,)),
        ("i0", i0, torch.int32, (g_n, o_n, pp)),
        ("j0", j0, torch.int32, (g_n, o_n, pp)),
        ("dens", dens, F32, (g_n, o_n, pp)),
        ("st_re", st_re, F32, (g_n, n, nf)),
        ("st_im", st_im, F32, (g_n, n, nf)),
        *([("scale", scale, F32, (o_n,))] if scale is not None else []),
    ])
    if n > MAX_N:
        raise ValueError(f"fourier_project_block: N={n} too large (its twiddle table must fit "
                         f"shared memory: N ≤ {MAX_N})")
    if o_n > 65535:
        raise ValueError(f"fourier_project_block: {o_n} orientations exceed the grid limit 65535")
    lib = _build.load()
    out_re = torch.empty((o_n, n, nf), dtype=F32, device=dens.device)
    out_im = torch.empty_like(out_re)
    with torch.cuda.device(dens.device):
        stream = torch.cuda.current_stream(dens.device).cuda_stream
        status = lib.bioem_fourier_project(
            i0.data_ptr(), j0.data_ptr(), dens.data_ptr(), counts.data_ptr(),
            st_re.data_ptr(), st_im.data_ptr(), None if scale is None else scale.data_ptr(),
            g_n, o_n, pp, n, nf,
            out_re.data_ptr(), out_im.data_ptr(), stream,
        )
    _build.check(status, "fourier_project_block")
    fourier_project_block.launches += 1
    return out_re, out_im


fourier_project_block.launches = 0


# ---------------------------------------------------------------------------
# G3: the projection's prologue
# ---------------------------------------------------------------------------

def project_prologue_plain(fspec, angles, points, radii, dens, norm_den, st_sums, *,
                           use_quaternions: bool):
    """Plain torch version of :func:`project_prologue`: the torch calls the
    engine made before G3 (rotation_matrices, grouped_snap, then tempden
    and the scale)."""
    rotm = rotation_matrices(angles, use_quaternions)
    i0, j0, de = grouped_snap(fspec, rotm, points, radii, dens)  # (G, O, Pp)
    tempden = torch.matmul(de.sum(dim=2).T, st_sums.to(F32))  # (O,)
    return i0, j0, de, norm_den / tempden


def project_prologue(
    fspec,  # core.projection.FourierProjectionSpec: N, pixel size, shifts, G, Pp
    angles: torch.Tensor,  # (O, 4) f32 — the block's orientation rows
    points: torch.Tensor,  # (G·Pp, 3) f32 — the radius-grouped model
    radii: torch.Tensor,  # (G·Pp,) f32
    dens: torch.Tensor,  # (G·Pp,) f32 — padding slots 0
    norm_den: torch.Tensor,  # () f32
    st_sums: torch.Tensor,  # (G,) f32 — unit-stencil sums
    *,
    use_quaternions: bool,
):
    """G3: K2's inputs for an orientation block — (i0, j0, de, scale):
    snapped pixel positions (G, O, Pp) int32 ×2, bounds-masked densities
    (G, O, Pp) f32 and norm_den/tempden (O,) f32 (module docstring)."""
    fn = "project_prologue"
    dev = angles.device
    if dev.type == "cpu":
        return project_prologue_plain(fspec, angles, points, radii, dens, norm_den, st_sums,
                                      use_quaternions=use_quaternions)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    g_n, pp, n = fspec.n_groups, fspec.group_pad, fspec.n_pixels
    o_n = angles.shape[0]
    _build.check_tensors(fn, dev, [
        ("angles", angles, F32, (o_n, 4)), ("points", points, F32, (g_n * pp, 3)),
        ("radii", radii, F32, (g_n * pp,)), ("dens", dens, F32, (g_n * pp,)),
        ("norm_den", norm_den, F32, ()), ("st_sums", st_sums, F32, (g_n,)),
    ])
    lib = _build.load()
    snaps = torch.empty((2, g_n, o_n, pp), dtype=torch.int32, device=dev)
    de = torch.empty((g_n, o_n, pp), dtype=F32, device=dev)
    scale = torch.empty((o_n,), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bioem_project_prologue(
            angles.data_ptr(), int(bool(use_quaternions)), points.data_ptr(), radii.data_ptr(),
            dens.data_ptr(), st_sums.data_ptr(), norm_den.data_ptr(), o_n, g_n, pp, n,
            float(np.float32(fspec.pixel_size)), int(fspec.shift_x), int(fspec.shift_y),
            snaps[0].data_ptr(), snaps[1].data_ptr(), de.data_ptr(), scale.data_ptr(), stream,
        )
    _build.check(status, fn)
    project_prologue.launches += 1
    return snaps[0], snaps[1], de, scale


project_prologue.launches = 0


# ---------------------------------------------------------------------------
# G4: the raster projection
# ---------------------------------------------------------------------------

# The largest N G4 takes (csrc/project_raster.cu's kMaxN: a pixel's row and
# column are packed in 10 bits each) and the largest stencil half-width (a
# point's reach is packed in 10 bits; the C entry
# bioem_raster_max_stencil_half says the same; a card test compares them).
RASTER_MAX_N = 512
RASTER_MAX_STENCIL_HALF = 1023
# The lattice variant's widest reach (its kernel's instances), its tile and
# the margin of its walk around the widened tile, in pixels
# (csrc/project_raster.cu's kLMaxReach, kLTile, kLMargin; the C entries
# bioem_raster_lattice_max_reach, _tile and _margin say the same, and a card
# test compares them): what the plain twin of its walk (tests) mirrors.
RASTER_LATTICE_MAX_REACH = 3
RASTER_LATTICE_TILE = 32
RASTER_LATTICE_MARGIN = 1.0


def raster_project_plain(spec, angles, points, radii, dens, norm_den, *, use_quaternions: bool):
    """Plain torch version of :func:`raster_project`: the torch calls the
    engine made before G4 (rotation_matrices, then project_batch)."""
    return project_batch(spec, rotation_matrices(angles, use_quaternions), points, radii, dens,
                         norm_den)


def raster_project(
    spec,  # core.projection.ProjectionSpec: N, pixel size, shifts, stencil_half
    angles: torch.Tensor,  # (O, 4) f32 — the block's orientation rows
    points: torch.Tensor,  # (P, 3) f32 — the model's points, as read (padding included)
    radii: torch.Tensor,  # (P,) f32
    dens: torch.Tensor,  # (P,) f32 — padding points 0
    norm_den: torch.Tensor,  # () f32
    *,
    use_quaternions: bool,
    lattice=None,
    snaps: torch.Tensor = None,
    scale: torch.Tensor = None,
):
    """G4: the (O, N, N) f32 projections of an orientation block, times
    norm_den/tempden — the contract of core.projection.project_batch on the
    rows' rotation matrices (module docstring). ``lattice``, (axes, shape,
    radius) where the model's first nx·ny·nz points are the voxel lattice
    core.projection.lattice_axes found (axes: core.projection
    .lattice_field's (nx + ny + nz + 1,) f32 on the card; radius: every
    point's, a Python float), runs the lattice variant: a CTA per pixel
    tile walks the lattice's planes, no entries, two launches; else the
    generic walk over the point list (csrc/project_raster.cu's header). For a check of the kernels,
    ``snaps``, an (O, 2, P) int32 tensor on the card, also receives each
    point's snapped pixel (i0, j0) (the lattice variant: each voxel whose
    snap lies in the frame; the other entries are left as they were), and
    ``scale``, (O,) f32, each orientation's norm_den/tempden; the plain
    version, the CPU's for both variants, takes neither. The scratch
    (generic: the bins' counts and their entries, 16 bytes per entry,
    sized for every point meeting the most bins the stencil's reach bound
    lets it, ~5.8 GB at O = 8 for a 224³ voxel map; lattice: one f64 per
    (orientation, tile)) is allocated per call, so a captured block step
    holds it in its graph's pool."""
    fn = "raster_project"
    dev = angles.device
    if dev.type == "cpu":
        if snaps is not None or scale is not None:
            raise ValueError(f"{fn}: snaps and scale are written by the kernel, not the plain "
                             "version")
        return raster_project_plain(spec, angles, points, radii, dens, norm_den,
                                    use_quaternions=use_quaternions)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    o_n, p_n, n, s = angles.shape[0], points.shape[0], spec.n_pixels, spec.stencil_half
    _build.check_tensors(fn, dev, [
        ("angles", angles, F32, (o_n, 4)), ("points", points, F32, (p_n, 3)),
        ("radii", radii, F32, (p_n,)), ("dens", dens, F32, (p_n,)),
        ("norm_den", norm_den, F32, ()),
        *([("snaps", snaps, torch.int32, (o_n, 2, p_n))] if snaps is not None else []),
        *([("scale", scale, F32, (o_n,))] if scale is not None else []),
    ])
    if n > RASTER_MAX_N:
        raise ValueError(f"{fn}: N={n} too large (a pixel is packed in 10 bits a coordinate: "
                         f"N ≤ {RASTER_MAX_N})")
    if s > RASTER_MAX_STENCIL_HALF:
        raise ValueError(f"{fn}: stencil_half {s} too large (an entry packs a point's reach "
                         f"in 10 bits: ≤ {RASTER_MAX_STENCIL_HALF})")
    if o_n > 65535:
        raise ValueError(f"{fn}: {o_n} orientations exceed the grid limit 65535")
    lib = _build.load()
    pix = float(np.float32(spec.pixel_size))
    # the plain version's constants, as its Python expressions round them
    c_chord = float(np.float32(pix * pix * 2.0))
    c_den = float(np.float32(4.0 * float(np.float32(np.pi))))
    out = torch.empty((o_n, n, n), dtype=F32, device=dev)
    if lattice is not None:
        axes, shape, radius = lattice
        nx, ny, nz = (int(v) for v in shape)
        _build.check_tensors(fn, dev, [("axes", axes, F32, (nx + ny + nz + 1,))])
        if nx * ny * nz > p_n:
            raise ValueError(f"{fn}: a lattice of {nx}×{ny}×{nz} voxels exceeds the {p_n} "
                             "points")
        nbytes = lib.bioem_raster_lattice_scratch_bytes(o_n, n)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.bioem_raster_project_lattice(
                angles.data_ptr(), int(bool(use_quaternions)), axes.data_ptr(), nx, ny, nz,
                dens.data_ptr(), norm_den.data_ptr(), o_n, p_n, n, pix, int(spec.shift_x),
                int(spec.shift_y), s, float(np.float32(radius)), c_chord, c_den, out.data_ptr(),
                None if snaps is None else snaps.data_ptr(),
                None if scale is None else scale.data_ptr(), scratch.data_ptr(), nbytes, stream,
            )
        _build.check(status, fn)
        raster_project.launches += 1
        return out
    nbytes = lib.bioem_raster_scratch_bytes(o_n, p_n, n, s, pix)
    if nbytes == 0:
        raise ValueError(f"{fn}: {p_n} points at stencil_half {s} exceed the kernels' "
                         "int32 entry offsets")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bioem_raster_project(
            angles.data_ptr(), int(bool(use_quaternions)), points.data_ptr(), radii.data_ptr(),
            dens.data_ptr(), norm_den.data_ptr(), o_n, p_n, n, pix, int(spec.shift_x),
            int(spec.shift_y), s, c_chord, c_den, out.data_ptr(),
            None if snaps is None else snaps.data_ptr(),
            None if scale is None else scale.data_ptr(), scratch.data_ptr(), nbytes, stream,
        )
    _build.check(status, fn)
    raster_project.launches += 1
    return out


raster_project.launches = 0


def bounds_census(angles, points, radii, *, n: int, pixel_size: float, shift_x: int,
                  shift_y: int, use_quaternions: bool) -> torch.Tensor:
    """Points dropped out of the frame per orientation, (O,) int64 on the
    card: the snap of csrc/project_snap.cuh (G3's and G4's) over every
    orientation row of ``angles`` (O, 4) and every point of ``points`` (P,
    3) and ``radii`` (P,), each (orientation, point) once
    (csrc/project_raster.cu ``bounds_census_kernel``). The card's twin of
    core.projection.projection_oob_report's count."""
    fn = "bounds_census"
    dev = angles.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: a card kernel; the CPU runs "
                         "core.projection.projection_oob_report")
    o_n, p_n = angles.shape[0], points.shape[0]
    _build.check_tensors(fn, dev, [
        ("angles", angles, F32, (o_n, 4)), ("points", points, F32, (p_n, 3)),
        ("radii", radii, F32, (p_n,)),
    ])
    oob = torch.zeros((o_n,), dtype=torch.int64, device=dev)
    if p_n == 0:
        return oob
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bioem_bounds_census(
            angles.data_ptr(), int(bool(use_quaternions)), o_n, points.data_ptr(),
            radii.data_ptr(), p_n, n, float(np.float32(pixel_size)), int(shift_x), int(shift_y),
            oob.data_ptr(), stream)
    _build.check(status, fn)
    bounds_census.launches += 1
    return oob


bounds_census.launches = 0
