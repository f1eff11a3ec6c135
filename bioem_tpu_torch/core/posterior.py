"""Closed-form log-posterior + displacement integration + streaming LSE.

PyTorch counterpart of ``bioem_tpu.core.posterior`` (reference
``calc_logpro`` / ``calProb`` / ``doRefMapFFT``, bioem_algorithm.h:18-198,
and ``calculateCCFFT``, bioem.cpp:1435-1459). Same decomposition:

    logpro(d) = A·log1p(u_d) + K,   A = (3−N²)/2
    u_d = (2·sref·sC·cc_d − N²·cc_d²) / F0
    F0  = N²·ssref·ssC − ssref·sC² − sref²·ssC     (= firstele at cc=0)
    K   = A·log F0 + (N²/2−2)·log((N²−2)·ForLogProb) − prior

K and every per-(orientation, ctf, image) constant are float64; the
displacement-varying part stays float32 with relative accuracy. The
displacement lattice is evaluated as two small complex matrix products
``Re(Wx @ (conv ⊙ conj(img) ⊙ h) @ Wyᵀ)`` instead of a full inverse FFT.

The streaming state is updated in place by :func:`merge_block`: the
engine owns it and runs a plain loop over orientation blocks.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..defs import MIN_PROB

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32


# ---------------------------------------------------------------------------
# Host-side precomputed constants (NumPy copies of the JAX package's)
# ---------------------------------------------------------------------------

def hermitian_weights(n: int) -> np.ndarray:
    """Column weights for half-spectrum sums (reference bioem.cpp:1892-1914).

    Even N: (1, 2, …, 2, 1); odd N: (1, 2, …, 2)."""
    nf = n // 2 + 1
    h = np.full(nf, 2.0, np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[-1] = 1.0
    return h


def stride_fold(stride: int, n: int, disp: np.ndarray) -> int:
    """Fold factor for the comparison kernel's wx weights.

    The fold sums p rows j and j + k·N/s before the stage-1 contraction,
    which is valid only when wx[d, j] = e^{2πi·j·disp_d/N} has period N/s
    in j — i.e. s | N AND every displacement is a multiple of s. The
    reference's −maxD..maxD stride-s sweep (bioem_algorithm.h:156-197)
    yields non-multiples whenever maxD % s != 0 (e.g. maxD=5, s=3 →
    {−5,−2,1,4}), so the second condition is checked explicitly."""
    if stride > 1 and n % stride == 0 and (np.asarray(disp) % stride == 0).all():
        return stride
    return 1


def displacement_dft_weights(n: int, disp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """DFT weight matrices evaluating the inverse FFT at the displacement lattice.

    wx[d, n'] = exp(+2πi·n'·disp_d/N)  (full rows,   shape (D, N))
    wy[d, f]  = exp(+2πi·f·disp_d/N)   (half columns, shape (D, N/2+1))

    Sign matches FFTW's unnormalised c2r backward transform
    (reference bioem.cpp:1458, value normalisation bioem_algorithm.h:163).
    """
    nf = n // 2 + 1
    freq_n = np.arange(n)
    freq_f = np.arange(nf)
    ph_x = 2.0 * np.pi * np.outer(disp.astype(np.float64), freq_n) / n
    ph_y = 2.0 * np.pi * np.outer(disp.astype(np.float64), freq_f) / n
    wx = np.exp(1j * ph_x).astype(np.complex64)
    wy = np.exp(1j * ph_y).astype(np.complex64)
    return wx, wy


# ---------------------------------------------------------------------------
# Device-side math
# ---------------------------------------------------------------------------

def convolution_sums(conv_re: torch.Tensor, conv_im: torch.Tensor, h: torch.Tensor, n_pixels: int):
    """sumC and sumsquareC of the convolved projection from its spectrum.

    Reference bioem.cpp:1885-1918: sumC = DC term; sumsquareC = Parseval
    with Hermitian double-counting, divided by N².
    conv_re/conv_im: (..., N, F) float32 → (sumC, ssqC) each (...,) float32.
    """
    sum_c = conv_re[..., 0, 0].to(F32)
    mag2 = conv_re**2 + conv_im**2
    ssq = torch.sum(mag2 * h[None, :], dim=(-2, -1)) / float(n_pixels * n_pixels)
    return sum_c, ssq


def ctf_prior_term(amp, pha, env, p_static) -> torch.Tensor:
    """The Gaussian-prior correction subtracted from logpro.

    Copied exactly from reference bioem_algorithm.h:49-67 including the
    sign quirk: ``logpro -= a - b - c`` so the defocus and amplitude terms
    are effectively *added*. f64 per ctf — cheap.
    """
    amp = amp.to(F64)
    pha = pha.to(F64)
    env = env.to(F64)
    sb = p_static.sigma_prior_bctf
    sd = p_static.sigma_prior_defocus
    sa = p_static.sigma_prior_amp
    dc = p_static.prior_defocus_center
    ac = p_static.prior_amp_center
    if p_static.use_psf:
        denom = env * env + pha * pha
        env_t = 4.0 * math.pi**2 * env / denom
        pha_t = 4.0 * math.pi**2 * pha / denom
    else:
        env_t = env
        pha_t = pha
    return (
        env_t * env_t / 2.0 / (sb * sb)
        - (pha_t - dc) ** 2 / 2.0 / (sd * sd)
        - (amp - ac) ** 2 / 2.0 / (sa * sa)
    )


def logpro_constants(
    sum_c: torch.Tensor,  # (O, C) f32
    ssq_c: torch.Tensor,  # (O, C) f32
    sum_ref: torch.Tensor,  # (I,) f32
    ssq_ref: torch.Tensor,  # (I,) f32
    prior: torch.Tensor,  # (O, C) f64
    ntot: float,
    images_normalized: bool = False,
):
    """F0 and K of the split-precision decomposition. Returns f64 (O, C, I).

    log(F0) is decomposed so the f64 logs run on (I,) and (O,C) arrays only:

        F0 = ssr·ssc·(g − h),  g = ntot − sc²/ssc,  h = sr²/ssr
        log F0 = log ssr + log ssc + log g + log1p(−h/g)

    With ``images_normalized`` (per-image mean removed, map.cpp:830-845)
    sr ≈ 0, so h/g ≲ 1e-7 and the per-(o,c,i) log1p correction is exact
    in f32. Otherwise (NO_MAP_NORM / DC-dominated images) F0 = ntot·ssr·ssc
    and the −ssr·sc² − sr²·ssc terms move into the f64 u of
    :func:`displacement_lse`."""
    sc = sum_c.to(F64)[:, :, None]
    ssc = ssq_c.to(F64)[:, :, None]
    sr = sum_ref.to(F64)[None, None, :]
    ssr = ssq_ref.to(F64)[None, None, :]
    ntot = float(ntot)
    a_coef = (3.0 - ntot) * 0.5
    forlog = ssc * ntot - sc * sc
    if images_normalized:
        g = forlog / ssc  # (O, C, 1)
        h = sr * sr / ssr  # (1, 1, I)
        f0 = ssr * ssc * (g - h)
        ratio = h / g  # (O, C, I)
        corr = torch.log1p(-(ratio.to(F32))).to(F64)
        log_f0 = torch.log(ssr) + torch.log(ssc) + torch.log(g) + corr
    else:
        f0 = (ntot * ssr * ssc).expand(sc.shape[0], sc.shape[1], sr.shape[2])
        log_f0 = math.log(ntot) + torch.log(ssr) + torch.log(ssc)
    k = (
        a_coef * log_f0
        + (ntot * 0.5 - 2.0) * torch.log((ntot - 2.0) * forlog)
        - prior[:, :, None]
    )
    return f0, k


def displacement_cc(
    conv_re: torch.Tensor,  # (O, C, N, F) f32
    conv_im: torch.Tensor,
    img_re: torch.Tensor,  # (I, N, F) f32 — conj(rfft2(img))·h/N² prefolded
    img_im: torch.Tensor,
    wx_re: torch.Tensor,  # (D, N) f32
    wx_im: torch.Tensor,
    wy_re: torch.Tensor,  # (D, F) f32
    wy_im: torch.Tensor,
) -> torch.Tensor:
    """Cross-correlation values at the displacement lattice.

    cc[o,c,i,dx,dy] = Re( wx[dx] @ (conv[o,c] ⊙ img_fc[i]) @ wy[dy]ᵀ )

    Full-f32 einsums (the engine turns TF32 off on CUDA). Returns
    (O,C,I,D,D) float32.
    """
    p_re = conv_re[:, :, None] * img_re[None, None] - conv_im[:, :, None] * img_im[None, None]
    p_im = conv_re[:, :, None] * img_im[None, None] + conv_im[:, :, None] * img_re[None, None]
    ein = torch.einsum
    t1_re = ein("dn,ocinf->ocidf", wx_re, p_re) - ein("dn,ocinf->ocidf", wx_im, p_im)
    t1_im = ein("dn,ocinf->ocidf", wx_re, p_im) + ein("dn,ocinf->ocidf", wx_im, p_re)
    cc = ein("ef,ocidf->ocide", wy_re, t1_re) - ein("ef,ocidf->ocide", wy_im, t1_im)
    return cc.to(F32)


def refine_varying_max(cc_star, sum_c, sum_ref, f0, ntot):
    """f64 re-evaluation of the varying-part max A·log1p(u*) at the argmax
    displacement (f32-u formula: u = (2·sr·sC·cc − N²·cc²)/F0).

    The max's ABSOLUTE error enters log P directly (log Σexp(v) =
    m + log Σexp(v−m) for any m), so one f64 log1p per (o, c, i) removes
    the f32 log1p rounding from the posterior's absolute level. Returns
    f64."""
    cc64 = cc_star.to(F64)
    u = (
        2.0 * sum_ref.to(F64)[None, None, :]
        * sum_c.to(F64)[:, :, None] * cc64
        - float(ntot) * cc64 * cc64
    ) / f0
    a_coef = (3.0 - ntot) * 0.5
    return a_coef * torch.log1p(u)


def displacement_lse(
    cc: torch.Tensor,  # (O, C, I, D, D) f32
    sum_c: torch.Tensor,  # (O, C) f32
    sum_ref: torch.Tensor,  # (I,) f32
    f0: torch.Tensor,  # (O, C, I) f64
    ntot: float,
    f32_u: bool = True,
    ssq_c: Optional[torch.Tensor] = None,  # (O, C) f32 — required when f32_u=False
    ssq_ref: Optional[torch.Tensor] = None,  # (I,) f32
    repair: bool = True,
):
    """Max + sum-exp of A·log1p(u_d) over the displacement grid.

    Returns (m, sumexp, d_star, cc_star): per-(o,c,i) max of the varying
    part (f64 on the f32-u branch after the f64 repair, f32 otherwise;
    ``repair=False`` leaves the repair to the caller's merge, G2),
    Σexp(V−m) in f32, the flat argmax index d·D+e (first occurrence —
    the reference sweep's tie-breaking, bioem_algorithm.h:156-197), and
    the cc value at the argmax.

    ``f32_u=False`` pairs with logpro_constants' DC-capable reference
    F0 = ntot·ssr·ssc and evaluates the FULL varying part in f64:

        u = (2·sr·sc·cc − ntot·cc² − ssr·sc² − sr²·ssc) / F0
    """
    o, c, i, d1, d2 = cc.shape
    a_coef = (3.0 - ntot) * 0.5
    cc_flat = cc.reshape(o, c, i, d1 * d2)
    if f32_u:
        sc = sum_c[:, :, None, None]
        sr = sum_ref[None, None, :, None]
        f0_32 = f0.to(F32)[:, :, :, None]
        u = (
            2.0 * sr * sc * cc_flat - float(np.float32(ntot)) * cc_flat * cc_flat
        ) / f0_32
        v_flat = a_coef * torch.log1p(u)  # (O,C,I,D²) f32
        m = torch.amax(v_flat, dim=-1)
        d_star = torch.argmax(v_flat, dim=-1).to(I32)
        sumexp = torch.sum(torch.exp(v_flat - m[..., None]), dim=-1)
        cc_star = torch.gather(cc_flat, -1, d_star[..., None].long())[..., 0]
        # f64 repair of the max term; sumexp stays relative to the raw f32
        # max — log Σexp(v) = m + log Σexp(v−m) absorbs the difference.
        if repair:
            m = refine_varying_max(cc_star, sum_c, sum_ref, f0, ntot)
        return m, sumexp, d_star, cc_star
    cc64 = cc_flat.to(F64)
    sc = sum_c.to(F64)[:, :, None, None]
    sr = sum_ref.to(F64)[None, None, :, None]
    ssc = ssq_c.to(F64)[:, :, None, None]
    ssr = ssq_ref.to(F64)[None, None, :, None]
    num = (
        2.0 * sr * sc * cc64
        - float(ntot) * cc64 * cc64
        - ssr * sc * sc
        - sr * sr * ssc
    )
    u = num / f0[:, :, :, None]
    v_flat = (a_coef * torch.log1p(u)).to(F32)
    m = torch.amax(v_flat, dim=-1)
    d_star = torch.argmax(v_flat, dim=-1).to(I32)
    sumexp = torch.sum(torch.exp(v_flat - m[..., None]), dim=-1)
    cc_star = torch.gather(cc_flat, -1, d_star[..., None].long())[..., 0]
    return m, sumexp, d_star, cc_star


# ---------------------------------------------------------------------------
# Streaming posterior state
# ---------------------------------------------------------------------------

class PosteriorState(NamedTuple):
    """Per-image streaming accumulator (reference bioem_Probability,
    map.h:116-172): online log-sum-exp pair + argmax parameter tuple."""

    total: torch.Tensor  # (I,) f64
    const: torch.Tensor  # (I,) f64 — running max logpro (= Constoadd)
    best_orient: torch.Tensor  # (I,) i32
    best_conv: torch.Tensor  # (I,) i32
    best_cent_x: torch.Tensor  # (I,) i32 — already negated, as reported
    best_cent_y: torch.Tensor  # (I,) i32
    best_norm: torch.Tensor  # (I,) f64
    best_mu: torch.Tensor  # (I,) f64
    ang_total: Optional[torch.Tensor] = None  # (I, n_orient) f64
    ang_const: Optional[torch.Tensor] = None  # (I, n_orient) f64


def init_state(
    n_img: int, n_orient: int, write_angles: bool, device=None
) -> PosteriorState:
    """Reference bioem.cpp:681-699: Total ← 0, Constoadd ← MIN_PROB."""
    kw = dict(device=device)
    return PosteriorState(
        total=torch.zeros(n_img, dtype=F64, **kw),
        const=torch.full((n_img,), MIN_PROB, dtype=F64, **kw),
        best_orient=torch.zeros(n_img, dtype=I32, **kw),
        best_conv=torch.zeros(n_img, dtype=I32, **kw),
        best_cent_x=torch.zeros(n_img, dtype=I32, **kw),
        best_cent_y=torch.zeros(n_img, dtype=I32, **kw),
        best_norm=torch.zeros(n_img, dtype=F64, **kw),
        best_mu=torch.zeros(n_img, dtype=F64, **kw),
        ang_total=torch.zeros((n_img, n_orient), dtype=F64, **kw) if write_angles else None,
        ang_const=(
            torch.full((n_img, n_orient), MIN_PROB, dtype=F64, **kw)
            if write_angles else None
        ),
    )


def merge_block(
    state: PosteriorState,
    m: torch.Tensor,  # (O, C, I) — varying-part max
    sumexp: torch.Tensor,  # (O, C, I) f32
    d_star: torch.Tensor,  # (O, C, I) i32
    cc_star: torch.Tensor,  # (O, C, I) f32
    k_const: torch.Tensor,  # (O, C, I) f64
    sum_c: torch.Tensor,  # (O, C) f32
    ssq_c: torch.Tensor,  # (O, C) f32
    sum_ref: torch.Tensor,  # (I,) f32
    disp_vals: torch.Tensor,  # (D,) i32 signed displacements in sweep order
    orient_offset,  # global index of the block's first orientation: an int
    # or a 0-d integer tensor on the state's device (a captured block step)
    ntot: float,
    n_disp: int,
    ang_offset=None,  # the block's first column in the per-angle slabs
    # (an int or a 0-d tensor); None: orient_offset (the slabs hold every
    # orientation; a mesh slot's hold only its shard's)
) -> PosteriorState:
    """Fold one (orientation-block × ctf-bank × image) result into the state,
    IN PLACE (the state's tensors are overwritten; the same state is
    returned). The offset enters only through device arithmetic and device
    indices, so a block step captured in a CUDA graph reads it from a
    tensor the graph advances.

    Equivalent to the reference's sequential calProb loop
    (bioem_algorithm.h:94-141) merged hierarchically: same log-sum-exp
    value, same argmax under the strict-``>`` first-occurrence rule because
    (o, c) blocks arrive in reference iteration order.
    """
    o, c, i = m.shape
    logmax = k_const + m.to(F64)  # (O, C, I) f64 — per-(o,c) max logpro

    lm = logmax.reshape(o * c, i)
    block_max = torch.amax(lm, dim=0)  # (I,) f64
    oc_star = torch.argmax(lm, dim=0)  # first occurrence
    diff = (lm - block_max[None, :]).to(F32)
    # −inf − −inf = NaN when a block is fully masked (padding) — such lanes
    # contribute zero, not NaN.
    ex = torch.exp(diff)
    ex = torch.where(torch.isnan(diff), torch.zeros_like(ex), ex)
    block_sum = torch.sum(sumexp.reshape(o * c, i) * ex, dim=0).to(F64)  # (I,)

    new_const = torch.maximum(state.const, block_max)
    new_total = state.total * torch.exp(state.const - new_const) + block_sum * torch.exp(
        block_max - new_const
    )

    upd = block_max > state.const  # strict >, reference bioem_algorithm.h:96

    img_idx = torch.arange(i, device=m.device)
    o_star = torch.div(oc_star, c, rounding_mode="floor")
    c_star = oc_star % c
    sc_b = sum_c[o_star, c_star].to(F64)  # (I,)
    ssc_b = ssq_c[o_star, c_star].to(F64)
    cc_b = cc_star[o_star, c_star, img_idx].to(F64)
    d_b = d_star[o_star, c_star, img_idx].long()
    dx_b = disp_vals[torch.div(d_b, n_disp, rounding_mode="floor")]
    dy_b = disp_vals[d_b % n_disp]
    sr = sum_ref.to(F64)
    ntot64 = float(ntot)
    denom = sc_b * sc_b - ssc_b * ntot64
    norm_b = -(-sc_b * sr + ntot64 * cc_b) / denom  # bioem_algorithm.h:106-108
    mu_b = -(-sc_b * cc_b + ssc_b * sr) / denom  # bioem_algorithm.h:109-111

    state.best_orient.copy_(
        torch.where(upd, (orient_offset + o_star).to(I32), state.best_orient)
    )
    state.best_conv.copy_(torch.where(upd, c_star.to(I32), state.best_conv))
    state.best_cent_x.copy_(torch.where(upd, -dx_b, state.best_cent_x))
    state.best_cent_y.copy_(torch.where(upd, -dy_b, state.best_cent_y))
    state.best_norm.copy_(torch.where(upd, norm_b, state.best_norm))
    state.best_mu.copy_(torch.where(upd, mu_b, state.best_mu))
    state.total.copy_(new_total)
    state.const.copy_(new_const)

    if state.ang_total is not None:
        # Per-(image, orientation) accumulation (bioem_algorithm.h:130-141),
        # merged over the ctf axis then streamed into the global slab.
        ang_max = torch.amax(logmax, dim=1)  # (O, I)
        adiff = (logmax - ang_max[:, None, :]).to(F32)
        aex = torch.exp(adiff)
        aex = torch.where(torch.isnan(adiff), torch.zeros_like(aex), aex)
        ang_sum = torch.sum(sumexp * aex, dim=1).to(F64)  # (O, I)

        cols = torch.arange(o, device=m.device) + (
            orient_offset if ang_offset is None else ang_offset)  # the block's slab
        sl_tot = state.ang_total.index_select(1, cols)
        sl_con = state.ang_const.index_select(1, cols)
        am = ang_max.T  # (I, O)
        asum = ang_sum.T
        new_c = torch.maximum(sl_con, am)
        new_t = sl_tot * torch.exp(sl_con - new_c) + asum * torch.exp(am - new_c)
        state.ang_total.index_copy_(1, cols, new_t)
        state.ang_const.index_copy_(1, cols, new_c)
    return state
