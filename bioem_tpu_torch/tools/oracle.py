"""Plain-NumPy oracle of the reference BioEM math, all in f64.

The port's copy of the JAX package's oracle (``tests/oracle/oracle.py``):
a direct, loop-based transliteration of the reference formulas
(createProjection, createConvolutedProjectionMap, calcProbability and the
log-sum-exp of ``bioem::run``), with the same arithmetic in the same
order, on the port's NumPy host layer (``params``, ``core/ctf``,
``core/orientations``). It is deliberately slow and simple: run it only
on small configurations (the golden cases). ``tools/golden_error_budget``
holds the port's engine to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.ctf import build_ctf_bank
from ..core.orientations import OrientationSet
from ..params import (
    BioEMParams,
    displacement_lists,
    log_normalization_constant,
    make_ctf_grid,
    orientation_volume_quirked,
)

MIN_PROB = -999999.0


def rotmat_quat(q):
    """Reference bioem.cpp:1638-1646."""
    q0, q1, q2, q3 = q
    m = np.zeros((3, 3))
    m[0][0] = 1 - 2 * q1 * q1 - 2 * q2 * q2
    m[1][0] = 2 * (q0 * q1 - q2 * q3)
    m[2][0] = 2 * (q0 * q2 + q1 * q3)
    m[0][1] = 2 * (q0 * q1 + q2 * q3)
    m[1][1] = 1 - 2 * q0 * q0 - 2 * q2 * q2
    m[2][1] = 2 * (q1 * q2 - q0 * q3)
    m[0][2] = 2 * (q0 * q2 - q1 * q3)
    m[1][2] = 2 * (q1 * q2 + q0 * q3)
    m[2][2] = 1 - 2 * q0 * q0 - 2 * q1 * q1
    return m


def rotmat_euler(a, b, g):
    """Reference bioem.cpp:1664-1672 (ZXZ, Goldstein)."""
    m = np.zeros((3, 3))
    m[0][0] = math.cos(g) * math.cos(a) - math.cos(b) * math.sin(a) * math.sin(g)
    m[0][1] = math.cos(g) * math.sin(a) + math.cos(b) * math.cos(a) * math.sin(g)
    m[0][2] = math.sin(g) * math.sin(b)
    m[1][0] = -math.sin(g) * math.cos(a) - math.cos(b) * math.sin(a) * math.cos(g)
    m[1][1] = -math.sin(g) * math.sin(a) + math.cos(b) * math.cos(a) * math.cos(g)
    m[1][2] = math.cos(g) * math.sin(b)
    m[2][0] = math.sin(b) * math.sin(a)
    m[2][1] = -math.sin(b) * math.cos(a)
    m[2][2] = math.cos(b)
    return m


def project(p: BioEMParams, points, radii, densities, norm_den, rotmat):
    """Reference createProjection (bioem.cpp:1677-1818)."""
    n = p.n_pixels
    proj = np.zeros((n, n), dtype=np.float64)
    rot = points @ rotmat.T  # r' = R @ r per point
    tempden = 0.0
    for k in range(points.shape[0]):
        x, y = rot[k, 0], rot[k, 1]
        if radii[k] <= p.pixel_size:
            i = math.floor(x / p.pixel_size + n / 2.0 + 0.5)
            j = math.floor(y / p.pixel_size + n / 2.0 + 0.5)
            if 0 <= i < n and 0 <= j < n:
                proj[i, j] += densities[k]
                tempden += densities[k]
        else:
            i = math.floor(x / p.pixel_size + n / 2.0 + 0.5) - p.shift_x
            j = math.floor(y / p.pixel_size + n / 2.0 + 0.5) - p.shift_y
            irad = int(radii[k] / p.pixel_size) + 1
            rad2 = radii[k] * radii[k]
            if i < irad or j < irad or i >= n - irad or j >= n - irad:
                continue  # point skipped entirely (reference warns only)
            for ii in range(i - irad, i + irad + 1):
                for jj in range(j - irad, j + irad + 1):
                    dist = ((ii - i) ** 2 + (jj - j) ** 2) * p.pixel_size**2
                    if dist < rad2:
                        dd = (
                            p.pixel_size**2
                            * 2.0
                            * math.sqrt(rad2 - dist)
                            * densities[k]
                            * 3.0
                            / (4.0 * math.pi * radii[k] * rad2)
                        )
                        proj[ii, jj] += dd
                        tempden += dd
    proj *= norm_den / tempden  # density renormalisation bioem.cpp:1806-1818
    return proj


def convolve_sums(p: BioEMParams, proj_fft, ctf_fft):
    """Reference createConvolutedProjectionMap (bioem.cpp:1855-1923).

    conv = proj · conj(ctf); sumC = DC real part; sumsquareC = Parseval
    over the half-spectrum with Hermitian double-counting; /N².
    """
    n, nf = p.n_pixels, p.n_fft_1d
    conv = proj_fft * np.conj(ctf_fft)
    sum_c = conv[0, 0].real
    jloopend = nf - 1 if n % 2 == 0 else nf
    ssq = 0.0
    for i in range(n):
        for j in range(1, jloopend):
            ssq += 2 * (conv[i, j].real ** 2 + conv[i, j].imag ** 2)
        ssq += conv[i, 0].real ** 2 + conv[i, 0].imag ** 2
        if n % 2 == 0:
            ssq += conv[i, nf - 1].real ** 2 + conv[i, nf - 1].imag ** 2
    return conv, sum_c, ssq / (n * n)


def calc_logpro(p: BioEMParams, amp, pha, env, s, ss, cc, sref, ssref):
    """Reference bioem_algorithm.h:18-70, incl. the prior sign quirk."""
    ntot = p.n_total_pixels
    forlog = ss * ntot - s * s
    firstele = ntot * (ssref * ss - cc * cc) + 2 * sref * s * cc - ssref * s * s - sref * sref * ss
    logpro = (3 - ntot) * 0.5 * math.log(firstele) + (ntot * 0.5 - 2) * math.log((ntot - 2) * forlog)
    if not p.use_psf:
        logpro -= (
            env * env / 2.0 / p.sigma_prior_bctf**2
            - (pha - p.prior_defocus_center) ** 2 / 2.0 / p.sigma_prior_defocus**2
            - (amp - p.prior_amp_center) ** 2 / 2.0 / p.sigma_prior_amp**2
        )
    else:
        env_f = 4.0 * math.pi**2 * env / (env * env + pha * pha)
        pha_f = 4.0 * math.pi**2 * pha / (env * env + pha * pha)
        logpro -= (
            env_f * env_f / 2.0 / p.sigma_prior_bctf**2
            - (pha_f - p.prior_defocus_center) ** 2 / 2.0 / p.sigma_prior_defocus**2
            - (amp - p.prior_amp_center) ** 2 / 2.0 / p.sigma_prior_amp**2
        )
    return logpro


@dataclass
class OracleResult:
    log_prob: np.ndarray  # (n_img,) final log posterior
    constoadd: np.ndarray
    total: np.ndarray
    max_orient: np.ndarray
    max_conv: np.ndarray
    max_cent_x: np.ndarray  # already negated, as reported
    max_cent_y: np.ndarray
    max_norm: np.ndarray
    max_mu: np.ndarray
    angle_log: np.ndarray | None = None  # (n_img, n_orient) per-angle logP


def run_oracle(
    p: BioEMParams,
    orients: OrientationSet,
    points: np.ndarray,
    radii: np.ndarray,
    densities: np.ndarray,
    norm_den: float,
    images: np.ndarray,
) -> OracleResult:
    """Full sequential BioEM posterior (reference bioem::run bioem.cpp:659-907)."""
    n = p.n_pixels
    n_img = images.shape[0]
    grid = make_ctf_grid(p)
    ctf_bank = build_ctf_bank(p, grid)
    disp, cent = displacement_lists(p)

    sum_ref = images.reshape(n_img, -1).astype(np.float64).sum(axis=1).astype(np.float32)
    ssq_ref = (images.reshape(n_img, -1).astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    img_fft = np.stack([np.fft.rfft2(images[i]) for i in range(n_img)])

    total = np.zeros(n_img)
    const = np.full(n_img, MIN_PROB)
    m_or = np.zeros(n_img, np.int32)
    m_cv = np.zeros(n_img, np.int32)
    m_cx = np.zeros(n_img, np.int32)
    m_cy = np.zeros(n_img, np.int32)
    m_norm = np.zeros(n_img)
    m_mu = np.zeros(n_img)
    ang_total = np.zeros((n_img, orients.n)) if p.write_angles else None
    ang_const = np.full((n_img, orients.n), MIN_PROB) if p.write_angles else None

    for io in range(orients.n):
        if orients.use_quaternions:
            rm = rotmat_quat(orients.angles[io])
        else:
            a, b, g = orients.angles[io][:3]
            rm = rotmat_euler(a, b, g)
        proj = project(p, points, radii, densities, norm_den, rm)
        proj_fft = np.fft.rfft2(proj)
        for ic in range(grid.n):
            conv, s_c, ss_c = convolve_sums(p, proj_fft, ctf_bank[ic])
            amp, pha, env = float(grid.amp[ic]), float(grid.phase[ic]), float(grid.env[ic])
            for ii in range(n_img):
                cc_map = np.fft.irfft2(conv * np.conj(img_fft[ii]), s=(n, n))
                for dxi in range(len(disp)):
                    for dyi in range(len(disp)):
                        value = cc_map[cent[dxi], cent[dyi]]
                        lp = calc_logpro(
                            p, amp, pha, env, s_c, ss_c, value, sum_ref[ii], ssq_ref[ii]
                        )
                        if const[ii] < lp:
                            total[ii] *= math.exp(-lp + const[ii])
                            const[ii] = lp
                            m_cx[ii] = -disp[dxi]
                            m_cy[ii] = -disp[dyi]
                            m_or[ii] = io
                            m_cv[ii] = ic
                            ntot = p.n_total_pixels
                            m_norm[ii] = -(-s_c * sum_ref[ii] + ntot * value) / (
                                s_c * s_c - ss_c * ntot
                            )
                            m_mu[ii] = -(-s_c * value + ss_c * sum_ref[ii]) / (
                                s_c * s_c - ss_c * ntot
                            )
                        total[ii] += math.exp(lp - const[ii])
                        if p.write_angles:
                            if ang_const[ii, io] < lp:
                                ang_total[ii, io] *= math.exp(-lp + ang_const[ii, io])
                                ang_const[ii, io] = lp
                            ang_total[ii, io] += math.exp(lp - ang_const[ii, io])

    volu = orientation_volume_quirked(p, orients.voluang, grid)
    k = log_normalization_constant(p, volu)
    log_prob = np.log(total) + const + k
    angle_log = None
    if p.write_angles:
        angle_log = np.log(ang_total) + ang_const + k
    return OracleResult(
        log_prob, const, total, m_or, m_cv, m_cx, m_cy, m_norm, m_mu, angle_log
    )
