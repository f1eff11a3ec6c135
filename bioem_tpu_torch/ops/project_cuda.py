"""Radius-grouped Fourier projection: CUDA kernel wrapper + plain version.

Replaces ``bioem_tpu/ops/project_pallas.py:_project_kernel`` (entry
``fourier_project_block``). The kernel is ``csrc/project.cu`` (see its
header for what bounds it on the card and how the design answers that).

Contract (UNSCALED spectra; the caller applies norm_den/tempden):

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


def fourier_project_block_plain(i0, j0, dens, st_re, st_im, *, n: int, counts=None):
    """Plain torch version: per-point phase tables read from the same
    twiddle table, then complex einsum group contractions."""
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
):
    """UNSCALED projection spectra (O, N, F) ×2 (see module docstring)."""
    if dens.device.type == "cpu":
        return fourier_project_block_plain(i0, j0, dens, st_re, st_im, n=n, counts=counts)
    if dens.device.type != "cuda":
        raise ValueError(f"fourier_project_block: unsupported device {dens.device}")
    g_n, o_n, pp = i0.shape
    nf = n // 2 + 1
    for name, t, dt, shape in (
        ("counts", counts, torch.int32, (g_n,)),
        ("i0", i0, torch.int32, (g_n, o_n, pp)),
        ("j0", j0, torch.int32, (g_n, o_n, pp)),
        ("dens", dens, F32, (g_n, o_n, pp)),
        ("st_re", st_re, F32, (g_n, n, nf)),
        ("st_im", st_im, F32, (g_n, n, nf)),
    ):
        if t.device != dens.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"fourier_project_block: {name} must be {dt} {shape} on "
                f"{dens.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fourier_project_block: {name} must be contiguous")
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
            st_re.data_ptr(), st_im.data_ptr(),
            g_n, o_n, pp, n, nf,
            out_re.data_ptr(), out_im.data_ptr(), stream,
        )
    _build.check(status, "fourier_project_block")
    fourier_project_block.launches += 1
    return out_re, out_im


fourier_project_block.launches = 0

