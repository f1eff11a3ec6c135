"""CTF / PSF Fourier kernel bank.

Equivalent of reference ``CalculateRefCTF``
(reference param.cpp:1336-1620). Kernels are precomputed once on the
host (they are tiny: n_ctf × N × (N/2+1) complex64) and shipped to device as
a constant bank; per-orientation work on device is then just a broadcasted
complex multiply.

Two modes, as in the reference:

* **CTF mode** (default): the kernel is written *directly in Fourier space*
  on the rfft2 half-spectrum grid, normalised by its DC value, with the
  reference's row-mirroring quirk reproduced exactly (see
  :func:`_ctf_row_map`). Reference param.cpp:1536-1574.

* **PSF mode**: a real-space kernel on the periodic N×N grid, normalised by
  its sum, then rfft2'd. Reference param.cpp:1466-1535.
"""

from __future__ import annotations

import numpy as np

from ..params import BioEMParams, CTFGrid


def _ctf_value(radsq: np.ndarray, amp: float, phase: float, env: float) -> np.ndarray:
    """exp(−env·r²/2)·(−A·cos(pha·r²/2) − √(1−A²)·sin(pha·r²/2)).

    Shared by both modes (param.cpp:1497-1499 and 1554-1556); only the
    meaning of r² differs (real-space vs reciprocal-space).
    """
    radsq = radsq.astype(np.float32)
    amp = np.float32(amp)
    phase = np.float32(phase)
    env = np.float32(env)
    return np.exp(-radsq * env / np.float32(2.0)) * (
        -amp * np.cos(radsq * phase / np.float32(2.0))
        - np.sqrt(np.float32(1.0) - amp * amp) * np.sin(radsq * phase / np.float32(2.0))
    )


def _ctf_row_map(n: int) -> np.ndarray:
    """Final row→source-frequency-row mapping of the reference CTF writer.

    The reference (param.cpp:1548-1569) loops i = 0..N/2 writing row ``i``
    and mirror row ``N−i−1`` (note: *not* the Hermitian partner N−i).
    Because later iterations overwrite earlier ones, the net effect for even
    N is:

        row k          source freq-row
        0..N/2−2       k
        N/2−1          N/2        (overwritten by the i=N/2 mirror write)
        N/2            N/2
        N/2+1..N−1     N−1−k

    We reproduce this by replaying the write order.
    """
    nf = n // 2 + 1
    rowmap = np.zeros(n, dtype=np.int64)
    for i in range(nf):
        rowmap[i] = i
        rowmap[n - i - 1] = i
    return rowmap


def ctf_fourier_kernel(p: BioEMParams, amp: float, phase: float, env: float) -> np.ndarray:
    """One CTF-mode kernel on the (N, N/2+1) half-spectrum grid.

    radsq = (i² + j²)/N²/pixelSize² with i the *source* frequency row from
    :func:`_ctf_row_map`; normalised by the (0,0) value (= −amp).
    Reference param.cpp:1546-1574.
    """
    n, nf = p.n_pixels, p.n_fft_1d
    if amp < 1e-10:
        raise ValueError("CTF normalization AMP less than threshold < 10^-10")
    i = np.arange(nf, dtype=np.float32)[:, None]
    j = np.arange(nf, dtype=np.float32)[None, :]
    radsq = (i * i + j * j) / np.float32(n) / np.float32(n) / np.float32(p.pixel_size) / np.float32(p.pixel_size)
    vals = _ctf_value(radsq, amp, phase, env)
    norm = vals[0, 0]
    vals = vals / norm
    rowmap = _ctf_row_map(n)
    out = vals[rowmap, :]
    return out.astype(np.complex64)


def psf_fourier_kernel(p: BioEMParams, amp: float, phase: float, env: float) -> np.ndarray:
    """One PSF-mode kernel: real-space build + sum-normalise + rfft2.

    Periodic distance from (0,0): ri = i for i ≤ N/2 else N−i
    (param.cpp:1474-1495); radsq = (ri²+rj²)·pixelSize².
    """
    n = p.n_pixels
    idx = np.arange(n)
    r = np.where(idx < n // 2 + 1, idx, n - idx).astype(np.float32)
    radsq = (r[:, None] ** 2 + r[None, :] ** 2) * np.float32(p.pixel_size) ** 2
    kern = _ctf_value(radsq, amp, phase, env)
    kern = kern / kern.sum(dtype=np.float32)
    return np.fft.rfft2(kern.astype(np.float32)).astype(np.complex64)


def build_ctf_bank(p: BioEMParams, grid: CTFGrid) -> np.ndarray:
    """(n_ctf, N, N/2+1) complex64 kernel bank in the grid's (amp, phase,
    env) flattening order — the order that defines the argmax iConv index
    (param.cpp:1423-1583)."""
    kernels = np.empty((grid.n, p.n_pixels, p.n_fft_1d), dtype=np.complex64)
    make = psf_fourier_kernel if p.use_psf else ctf_fourier_kernel
    for k in range(grid.n):
        kernels[k] = make(p, float(grid.amp[k]), float(grid.phase[k]), float(grid.env[k]))
    return kernels
