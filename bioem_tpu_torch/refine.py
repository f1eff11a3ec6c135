"""Continuous MAP refinement of the maximizing parameters by autodiff.

PyTorch counterpart of ``bioem_tpu.refine`` (``torch.func`` where the JAX
package uses ``jax.grad``, ``jax.hessian`` and ``jax.vmap``). The reference
reports the *grid* argmax — orientation, CTF index, displacement, analytic
norm/offset (reference bioem.cpp:1141-1222) — and stops there. The
single-point log posterior ``calc_logpro`` (bioem_algorithm.h:18-70) is
differentiable in the continuous nuisance parameters, so the grid argmax
can be polished off-grid; the C++/CUDA reference has no analogue.

The objective is a *smooth surrogate* of the grid engine's forward model:
the same physics without its two non-smooth discretisation artifacts.

* Sub-pixel projection: each point sits at its exact continuous position
  (the Fourier shift phase) instead of the pixel snap of
  ``fourier_prologue``; each sphere keeps its pixel-sampled stencil.
* Clean CTF radial response: the intended Hermitian row frequency
  ``min(i, N−i)`` instead of the reference writer's row-mirror quirk
  (param.cpp:1548-1569, replayed by ``core.ctf`` for parity).
* Out-of-bounds density masking is omitted (non-smooth).

Orientation is a tangent-space rotation ``R = exp([ω]×)·R₀`` around the
grid argmax R₀; displacements enter through ``e^{i2π(n·dx + f·dy)/N}``.

**Optimizer: multi-start damped Newton** over the 8-vector (ω, d, CTF
pha/env/amp), the exact Hessian by forward-over-reverse autodiff
(``jacfwd`` of ``grad``, which also yields the gradient),
Levenberg damping, monotone accept/reject (``torch.where``, as the JAX
package's ``lax.scan`` body). Start 0 is the grid seed, the others are
jittered at grid-cell scale from ``np.random.default_rng(seed)``; images ×
starts run batched under ``torch.func.vmap``, the images in chunks on the
card so that the Hessian's tangents fit its memory. The k×k system
(k = 8) is solved directly in f64: the JAX package's f32 solve plus one
refinement step works around the TPU's f32-only LU, and the port keeps its
accuracy, not the workaround. Heavy tensors stay f32 and the five moments
and ``calc_logpro`` f64, as in the engine. The objective is plain torch on
the card (the JAX objective calls no Pallas kernel).

Two faults of the JAX package's refinement are fixed here, each with a CPU
test that shows the divergence (tests/test_torch_refine_faults.py):

* F2: with a CTF axis gated off, its value is a constant of the objective,
  not ``seed + 0·vec[k]``. At a legal grid amplitude of 1.0 the JAX
  objective keeps √(1−amp²) in the autodiff graph, whose derivative there
  is infinite: every gradient is NaN and no Newton step is ever taken.
* F1: with the amplitude freed (``refine_ctf_amp``) it is clamped to
  [1e-10, 0.9999], 1e-10 being the grid engine's own floor (core/ctf.py):
  at amp = 0 the CTF's DC normalisation divides by zero. Non-finite finals
  are masked before the argmax over starts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from .core.orientations import rotation_matrices
from .core.posterior import ctf_prior_term
from .core.projection import fourier_epilogue

F32 = torch.float32
F64 = torch.float64

# Lower bound for the refined CTF B-envelope (Å²-scaled Fourier damping):
# keeps exp(-r²·env/2) a decaying filter under refinement.
ENV_FLOOR = 1e-8
# Bounds of a freed amplitude (F1): the grid engine's floor (core/ctf.py
# refuses amp < 1e-10) and 0.9999, short of amp = 1 where the √(1−amp²)
# branch's gradient diverges.
AMP_FLOOR = 1e-10
AMP_CEIL = 0.9999


# ---------------------------------------------------------------------------
# Smooth forward-model pieces
# ---------------------------------------------------------------------------

def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation exp([ω]×), smooth at ω = 0 via sinc forms.

    sin(θ)/θ = sinc(θ/π) and (1−cos θ)/θ² = ½·sinc(θ/2π)²; the tiny bias
    inside the sqrt keeps the θ(ω) gradient finite at the ω = 0 seed."""
    theta = torch.sqrt(torch.sum(omega * omega) + 1e-24)
    a = torch.sinc(theta / math.pi)  # sin θ / θ
    half = theta / (2.0 * math.pi)
    b = 0.5 * torch.sinc(half) * torch.sinc(half)  # (1 − cos θ)/θ²
    wx, wy, wz = omega[0], omega[1], omega[2]
    zero = torch.zeros_like(wx)
    k = torch.stack([
        torch.stack([zero, -wz, wy]),
        torch.stack([wz, zero, -wx]),
        torch.stack([-wy, wx, zero]),
    ])
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a * k + b * torch.matmul(k, k)


def smooth_projection_phases(n, pixel_size, shift_x, shift_y, rotmat, points, radii):
    """Continuous (θx, θy) per point — the smooth limit of the grid
    engine's ``fourier_prologue`` pixel snap ``floor(x/pix + N/2 + 0.5)``
    (reference bioem.cpp:1715-1741). The SHIFT_X/Y offsets apply to
    large-radius points exactly as in the snapped path."""
    pix = float(np.float32(pixel_size))
    rot = torch.matmul(points, rotmat.T.to(points.dtype))
    half = float(n) / 2.0
    i_c = rot[:, 0] / pix + half
    j_c = rot[:, 1] / pix + half
    small = radii <= pix
    i0 = torch.where(small, i_c, i_c - shift_x)
    j0 = torch.where(small, j_c, j_c - shift_y)
    two_pi_n = float(np.float32(2.0 * math.pi / n))
    return -two_pi_n * i0, -two_pi_n * j0


def smooth_ctf_spectrum(n, pixel_size, use_psf, amp, pha, env,
                        cos_n=None, sin_n=None, cos_f=None, sin_f=None):
    """(N, F) real CTF/PSF transfer function, differentiable in
    (amp, pha, env).

    CTF mode: the reference formula (param.cpp:1546-1574) with the clean
    Hermitian row frequency min(i, N−i), DC-normalised. PSF mode: the
    real-space kernel (param.cpp:1474-1499), sum-normalised; its spectrum
    is real by the kernel's i→N−i symmetry and is evaluated with the
    supplied cosine/sine DFT tables ((N, N) and (F, N))."""
    amp = amp.to(F32)
    pha = pha.to(F32)
    env = env.to(F32)
    dev = amp.device

    def ctf_value(radsq):
        return torch.exp(-radsq * env / 2.0) * (
            -amp * torch.cos(radsq * pha / 2.0)
            - torch.sqrt(1.0 - amp * amp) * torch.sin(radsq * pha / 2.0)
        )

    nf = n // 2 + 1
    if not use_psf:
        idx = torch.arange(n, dtype=F32, device=dev)
        ri = torch.minimum(idx, n - idx)
        j = torch.arange(nf, dtype=F32, device=dev)
        radsq = (ri[:, None] ** 2 + j[None, :] ** 2) / float(
            np.float32(float(n * n) * pixel_size * pixel_size))
        vals = ctf_value(radsq)
        return vals / vals[0, 0]
    idx = torch.arange(n, device=dev)
    r = torch.where(idx < nf, idx, n - idx).to(F32)
    radsq = (r[:, None] ** 2 + r[None, :] ** 2) * float(np.float32(pixel_size * pixel_size))
    kern = ctf_value(radsq)
    kern = kern / torch.sum(kern)
    # Real spectrum of the symmetric kernel: C kern C_Fᵀ − S kern S_Fᵀ.
    return (torch.matmul(cos_n, torch.matmul(kern, cos_f.T))
            - torch.matmul(sin_n, torch.matmul(kern, sin_f.T)))


def _cc_at(p_re, p_im, n: int, d):
    """Re(Σ P·e^{i2π(n'·dx + f·dy)/N}) — the cross-correlation at a
    continuous displacement ``d`` (f64, pixels). Row frequencies are
    SIGNED: with raw 0..N−1 indices the interpolant passes through the
    integer-shift values but oscillates at the Nyquist scale between them;
    signed frequencies give the band-limited interpolation."""
    nf = n // 2 + 1
    dev = p_re.device
    kx = torch.remainder(torch.arange(n, dtype=F64, device=dev) + n // 2, n) - n // 2
    phx = 2.0 * math.pi * kx * d[0] / n
    phy = 2.0 * math.pi * torch.arange(nf, dtype=F64, device=dev) * d[1] / n
    cx, sx = torch.cos(phx), torch.sin(phx)
    cy, sy = torch.cos(phy), torch.sin(phy)
    t_re = torch.matmul(cx, p_re) - torch.matmul(sx, p_im)
    t_im = torch.matmul(cx, p_im) + torch.matmul(sx, p_re)
    return torch.dot(cy, t_re) - torch.dot(sy, t_im)


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------

def _logpro_smooth(theta, consts, static):
    """Single-point log posterior (reference calc_logpro,
    bioem_algorithm.h:18-70, priors included) at continuous parameters.

    theta: dict(omega (3,), d (2,), dctf (3,)) f64 perturbations around the
    per-image seed in ``consts``; ``static`` carries the problem's
    constants and the model/stencil banks shared by all images. A CTF axis
    that ``static["ctf_free"]`` (pha, env, amp; default all free) marks
    fixed takes its seed value, a constant of the objective (F2)."""
    n = static["n"]
    ntot = float(static["ntot"])
    rot = torch.matmul(exp_so3(theta["omega"].to(F32)), consts["rot0"])
    th_x, th_y = smooth_projection_phases(
        n, static["pixel_size"], static["shift_x"], static["shift_y"],
        rot, static["points"], static["radii"],
    )
    proj_re, proj_im = fourier_epilogue(
        static["fspec"], th_x, th_y, static["dens"], static["norm_den"],
        static["st_re"], static["st_im"], static["st_sums"],
        signed_rows=True,  # continuous positions need signed frequencies
    )
    dctf = theta["dctf"]
    free = static.get("ctf_free", (True, True, True))
    pha = consts["pha0"] + dctf[0].to(F32) if free[0] else consts["pha0"]
    # The envelope stays physical: env <= 0 would turn exp(-r²·env/2) into
    # a growing high-frequency amplifier the symmetric prior cannot stop.
    env = torch.clamp(consts["env0"] + dctf[1].to(F32) if free[1] else consts["env0"],
                      min=ENV_FLOOR)
    if free[2]:
        # F1: amp = 0 divides the DC normalisation by zero, hence the
        # floor; the ceiling is 0.9999 when refine_results frees the axis.
        amp = torch.clamp(consts["amp0"] + dctf[2].to(F32), min=AMP_FLOOR,
                          max=static.get("amp_hi", 1.0))
    else:
        amp = consts["amp0"]  # F2: every legal grid amplitude, 1.0 included
    ctf = smooth_ctf_spectrum(
        n, static["pixel_size"], static["use_psf"], amp, pha, env,
        static.get("cos_n"), static.get("sin_n"), static.get("cos_f"), static.get("sin_f"),
    )
    conv_re = proj_re * ctf
    conv_im = proj_im * ctf
    # Five moments in f64 (reference keeps these double: bioem.cpp:1887-1914).
    h = static["h"].to(F64)
    sum_c = conv_re[0, 0].to(F64)
    cr = conv_re.to(F64)
    ci = conv_im.to(F64)
    ssq_c = torch.sum((cr ** 2 + ci ** 2) * h[None, :]) / ntot
    # The image bank is prefolded conj(FFT)·h/N² (engine _image_arrays), so
    # the plain product-sum already carries the Hermitian weights and the
    # c2r normalisation of bioem_algorithm.h:163.
    ir = consts["img_re"].to(F64)
    ii = consts["img_im"].to(F64)
    cc = _cc_at(cr * ir - ci * ii, cr * ii + ci * ir, n, consts["d0"] + theta["d"])
    sr = consts["sum_ref"].to(F64)
    ssr = consts["ssq_ref"].to(F64)
    firstele = (
        ntot * (ssr * ssq_c - cc * cc)
        + 2.0 * sr * sum_c * cc
        - ssr * sum_c * sum_c
        - sr * sr * ssq_c
    )
    forlog = ssq_c * ntot - sum_c * sum_c
    # Positivity guard: far from the seed firstele can round to <= 0; the
    # clamp keeps that start finite (and terrible) instead of NaN.
    tiny = 1e-300
    logpro = (3.0 - ntot) * 0.5 * torch.log(torch.clamp(firstele, min=tiny)) + (
        ntot * 0.5 - 2.0
    ) * torch.log(torch.clamp((ntot - 2.0) * forlog, min=tiny))
    return logpro - ctf_prior_term(amp, pha, env, static["p_obj"])


# ---------------------------------------------------------------------------
# Optimizer: damped Newton over the (ω, d, dctf) vector
# ---------------------------------------------------------------------------

def _theta(vec):
    return {"omega": vec[:3], "d": vec[3:5], "dctf": vec[5:8]}


def _hess_grad(objective):
    """(vec, consts) → (∇²f, ∇f) of ``f = objective(vec, consts)`` by one
    forward-over-reverse pass (``jacfwd`` of ``grad``; the gradient rides
    along as the auxiliary output)."""
    def hess_grad(v, c):
        def g_aux(x):
            g = grad(objective)(x, c)
            return g, g
        return jacfwd(g_aux, has_aux=True)(v)
    return hess_grad


def _per_pair(fn):
    """``fn(vec, consts)`` lifted over (images, starts): vec (I, S, k),
    consts with leading dim I."""
    return vmap(vmap(fn, in_dims=(0, None)), in_dims=(0, 0))


def _newton_ascent(objective, hess_grad, vec0, consts, iters):
    """Levenberg-damped Newton ascent of ``objective(vec, consts)`` from
    every start of ``vec0`` (I, S, k), the images' constants ``consts``
    (leading dim I); ``hess_grad(vec, consts)`` gives (∇²f, ∇f). Returns
    (vec, value), (I, S, k) and (I, S).

    Per iteration: solve (λI − H)s = ∇f in f64 (an ascent direction for
    any λ above H's top eigenvalue); a singular or overflowed solve falls
    back to a small gradient step. Accept the step only if f improves
    (λ ↓ 0.4×), else reject (λ ↑ 4×): monotone by construction."""
    dim = vec0.shape[-1]
    hg = _per_pair(hess_grad)
    fb = _per_pair(objective)
    eye = torch.eye(dim, dtype=F64, device=vec0.device)
    vec = vec0
    lam = torch.ones(vec0.shape[:-1], dtype=F64, device=vec0.device)
    fv = fb(vec, consts)
    for _ in range(iters):
        h, g = hg(vec, consts)
        s, info = torch.linalg.solve_ex(lam[..., None, None] * eye - h, g)
        bad = (info != 0)[..., None] | ~torch.isfinite(s).all(dim=-1, keepdim=True)
        s = torch.where(bad, g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-12) * 1e-3, s)
        nf = fb(vec + s, consts)
        ok = nf > fv
        vec = torch.where(ok[..., None], vec + s, vec)
        fv = torch.where(ok, nf, fv)
        lam = torch.where(ok, torch.clamp(lam * 0.4, min=1e-6), torch.clamp(lam * 4.0, max=1e8))
    return vec, fv


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

@dataclass
class RefineResult:
    """Per-image refined maximizing parameters (all numpy, f64)."""

    rotmat: np.ndarray  # (I, 3, 3) refined rotations
    quaternion: np.ndarray  # (I, 4) same rotations as (q1,q2,q3,q4)
    cent_x: np.ndarray  # (I,) refined displacement, reference sign (−dx)
    cent_y: np.ndarray
    pha: np.ndarray  # (I,) refined CTF phase (= seed unless refine_ctf)
    env: np.ndarray
    amp: np.ndarray  # (I,) refined amplitude (= seed unless refine_ctf_amp)
    logpro_seed: np.ndarray  # (I,) smooth-model logpro at the grid argmax
    logpro_refined: np.ndarray  # (I,) best over starts (≥ logpro_seed)
    grad_norm: np.ndarray  # (I,) gradient norm at winner (stationarity)
    image_chunk: int = 0  # images per batch the refinement ran


def _rotmat_to_quaternion(r: np.ndarray) -> np.ndarray:
    """Rotation matrices (…,3,3) → quaternions matching the convention of
    ``rotmat_from_quaternion`` (core/orientations.py; reference
    bioem.cpp:1638-1646). Robust Shepperd branch selection."""
    r = np.asarray(r, np.float64)
    out = np.empty(r.shape[:-2] + (4,), np.float64)
    for idx in np.ndindex(r.shape[:-2]):
        m = r[idx]
        # rotmat_from_quaternion builds with q4 = scalar part and rows:
        # m[0,0] = q1²−q2²−q3²+q4², m[0,1] = 2(q1q2+q3q4), …
        t = np.trace(m)
        cand = np.array([m[0, 0], m[1, 1], m[2, 2], t])
        k = int(np.argmax(cand))
        if k == 3:
            q4 = 0.5 * math.sqrt(max(1.0 + t, 0.0))
            q1 = (m[1, 2] - m[2, 1]) / (4.0 * q4)
            q2 = (m[2, 0] - m[0, 2]) / (4.0 * q4)
            q3 = (m[0, 1] - m[1, 0]) / (4.0 * q4)
        elif k == 0:
            q1 = 0.5 * math.sqrt(max(1.0 + 2.0 * m[0, 0] - t, 0.0))
            q2 = (m[0, 1] + m[1, 0]) / (4.0 * q1)
            q3 = (m[2, 0] + m[0, 2]) / (4.0 * q1)
            q4 = (m[1, 2] - m[2, 1]) / (4.0 * q1)
        elif k == 1:
            q2 = 0.5 * math.sqrt(max(1.0 + 2.0 * m[1, 1] - t, 0.0))
            q1 = (m[0, 1] + m[1, 0]) / (4.0 * q2)
            q3 = (m[1, 2] + m[2, 1]) / (4.0 * q2)
            q4 = (m[2, 0] - m[0, 2]) / (4.0 * q2)
        else:
            q3 = 0.5 * math.sqrt(max(1.0 + 2.0 * m[2, 2] - t, 0.0))
            q1 = (m[2, 0] + m[0, 2]) / (4.0 * q3)
            q2 = (m[1, 2] + m[2, 1]) / (4.0 * q3)
            q4 = (m[0, 1] - m[1, 0]) / (4.0 * q3)
        out[idx] = (q1, q2, q3, q4)
    return out


def engine_banks(engine):
    """The banks refinement reads: the engine's own, or a mesh engine's
    with every image shard's rows gathered to its first slot's device (as
    the JAX package gathers a mesh engine's sharded banks). Refinement runs
    in one process: under several it raises before any work."""
    if not hasattr(engine, "gathered_banks"):
        return engine.banks
    from .parallel.distributed import process_count

    if process_count() > 1:
        raise NotImplementedError(
            "refine_results runs in one process (it gathers the mesh's image "
            "rows to one device); in a multi-process run refine in one process "
            "with the same inputs"
        )
    return engine.gathered_banks()


def refine_static(engine, refine_ctf: bool = False, refine_ctf_amp: bool = False,
                  banks=None) -> dict:
    """The objective's problem constants and model banks (on the engine's
    device) for ``engine``: ``static`` of :func:`_logpro_smooth`.
    ``banks``: :func:`engine_banks` when None."""
    if engine.fspec is None:
        raise ValueError(
            "refine_results requires the Fourier projection layout "
            "(engine.fspec); the raster path has no smooth surrogate. "
            "Rebuild the engine without force_raster and with ≤32 radius "
            "groups."
        )
    p = engine.p
    b = engine_banks(engine) if banks is None else banks
    n = p.n_pixels
    static = {
        "n": n,
        "ntot": float(p.n_total_pixels),
        "pixel_size": float(p.pixel_size),
        "shift_x": int(p.shift_x),
        "shift_y": int(p.shift_y),
        "use_psf": bool(p.use_psf),
        "fspec": engine.fspec,
        "p_obj": p,
        "points": b.points,
        "radii": b.radii,
        "dens": b.dens,
        "norm_den": b.norm_den,
        "st_re": b.st_re,
        "st_im": b.st_im,
        "st_sums": b.st_sums,
        "h": b.h,
        "ctf_free": (refine_ctf, refine_ctf, refine_ctf_amp),
        "amp_hi": AMP_CEIL if refine_ctf_amp else 1.0,
    }
    if p.use_psf:
        k1 = np.arange(n)
        ph_n = 2.0 * np.pi * np.outer(k1, k1) / n
        ph_f = 2.0 * np.pi * np.outer(np.arange(n // 2 + 1), k1) / n
        for name, v in (("cos_n", np.cos(ph_n)), ("sin_n", np.sin(ph_n)),
                        ("cos_f", np.cos(ph_f)), ("sin_f", np.sin(ph_f))):
            static[name] = torch.as_tensor(v.astype(np.float32), device=engine.device)
    return static


def auto_image_chunk(engine, n_starts: int) -> int:
    """Images per batch on the card: the Hessian's forward-over-reverse
    pass holds the objective's intermediates for the primal and its eight
    tangents, per (image, start) pair. Per pair that is ~6 times
    ``per_eval`` below (the objective's tensors: per-point phase tables
    (P, N + F), per-group spectra (G, N, F), ~30 f64 (N, F) arrays) —
    measured on an H100 at the production problem (N = 224, 1120 point
    slots in 14 groups; chip_smoke.py): 23.8 GiB peak for 8 images × 16
    starts, ~200 MB per pair. The chunk fills half the card's free
    memory."""
    fs = engine.fspec
    n = engine.p.n_pixels
    nf = n // 2 + 1
    pts = fs.n_groups * fs.group_pad
    per_eval = 4 * (10 * pts * (n + nf) + 8 * fs.n_groups * n * nf) + 8 * 30 * n * nf
    pair = 6 * per_eval
    free, _total = torch.cuda.mem_get_info(engine.device)
    return max(1, int(0.5 * free // (pair * max(1, n_starts))))


def refine_results(
    engine,
    results,
    iters: int = 60,
    n_starts: int = 16,
    jitter_rot: float = 0.12,
    jitter_disp: Optional[float] = None,
    refine_ctf: bool = False,
    refine_ctf_amp: bool = False,
    image_indices: Optional[np.ndarray] = None,
    seed: int = 0,
    image_chunk: Optional[int] = None,
) -> RefineResult:
    """Polish each image's grid-argmax parameters by multi-start damped
    Newton on the smooth log posterior. ``engine`` is a run
    :class:`BioEMEngine` (its banks are reused, on its device) or a mesh
    engine in one process (:func:`engine_banks`); ``results`` its
    :class:`Results`.

    Start 0 is the grid seed; the other ``n_starts−1`` jitter ω by
    N(0, jitter_rot) per axis and d uniformly within ±jitter_disp
    (default: 0.6 × the displacement lattice step). The best final log
    posterior per image wins (≥ the seed's by monotone accept/reject;
    non-finite finals never win). ``refine_ctf`` also optimises the CTF
    (phase, envelope) pair; ``refine_ctf_amp`` frees the amplitude as
    well, clamped to [1e-10, 0.9999] against the Gaussian amp prior
    (bioem_algorithm.h:49-67). ``image_chunk`` images run per batch
    (default: all on the CPU, :func:`auto_image_chunk` on the card); the
    result records it.
    """
    banks = engine_banks(engine)
    static = refine_static(engine, refine_ctf, refine_ctf_amp, banks)
    p = engine.p
    dev = engine.device
    idx = np.arange(engine.n_img) if image_indices is None else np.asarray(image_indices)
    ang = engine.orients.angles[np.asarray(results.best_orient)[idx]]
    rot0 = rotation_matrices(torch.as_tensor(ang.astype(np.float32), device=dev),
                             engine.orients.use_quaternions).to(F32)
    conv_idx = np.asarray(results.best_conv)[idx]
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    amp0 = host(banks.amp)[conv_idx]
    pha0 = host(banks.pha)[conv_idx]
    env0 = host(banks.env)[conv_idx]
    d0 = np.stack([-np.asarray(results.best_cent_x)[idx],
                   -np.asarray(results.best_cent_y)[idx]], axis=1).astype(np.float64)
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)  # noqa: E731
    rows = torch.as_tensor(idx, dtype=torch.long, device=dev)
    consts = {
        "rot0": rot0,
        "amp0": t(amp0, F32),
        "pha0": t(pha0, F32),
        "env0": t(env0, F32),
        "d0": t(d0, F64),
        "img_re": banks.img_re.index_select(0, rows),
        "img_im": banks.img_im.index_select(0, rows),
        "sum_ref": banks.sum_ref.index_select(0, rows),
        "ssq_ref": banks.ssq_ref.index_select(0, rows),
    }
    gate = np.array([refine_ctf, refine_ctf, refine_ctf_amp], np.float64)

    def objective(vec, c):
        return _logpro_smooth(_theta(vec), c, static)

    if jitter_disp is None:
        jitter_disp = 0.6 * float(p.grid_space_center)
    rng = np.random.default_rng(seed)
    starts = np.zeros((n_starts, 8))
    if n_starts > 1:
        starts[1:, :3] = rng.normal(0.0, jitter_rot, (n_starts - 1, 3))
        starts[1:, 3:5] = rng.uniform(-jitter_disp, jitter_disp, (n_starts - 1, 2))
        if refine_ctf_amp:
            # Grid-cell-scale amp exploration (grids step amp by ~0.05-0.1).
            starts[1:, 7] = rng.uniform(-0.05, 0.05, n_starts - 1)
    starts_t = t(starts, F64)

    n_img = len(idx)
    if image_chunk is None:
        image_chunk = auto_image_chunk(engine, n_starts) if dev.type == "cuda" else n_img
    image_chunk = max(1, min(int(image_chunk), n_img))
    out = {k: [] for k in ("vec", "lp0", "lp1", "gnorm")}
    zero = torch.zeros(8, dtype=F64, device=dev)
    for s in range(0, n_img, image_chunk):
        c = {k: v[s:s + image_chunk] for k, v in consts.items()}
        m = c["rot0"].shape[0]
        lp0 = vmap(objective, in_dims=(None, 0))(zero, c)
        vecs, finals = _newton_ascent(objective, _hess_grad(objective),
                                      starts_t.expand(m, n_starts, 8), c, iters)
        # F1: a non-finite final never wins the argmax over starts.
        best = torch.argmax(torch.where(torch.isfinite(finals), finals,
                                        torch.full_like(finals, -torch.inf)), dim=1)
        pick = torch.arange(m, device=dev)
        vec = vecs[pick, best]
        g = vmap(grad(objective), in_dims=(0, 0))(vec, c)
        out["vec"].append(vec)
        out["lp0"].append(lp0)
        out["lp1"].append(finals[pick, best])
        out["gnorm"].append(torch.linalg.vector_norm(g, dim=-1))
    res = {k: torch.cat(v) for k, v in out.items()}
    vec = res["vec"]
    rot = host(torch.matmul(vmap(exp_so3)(vec[:, :3].to(F32)), rot0)).astype(np.float64)
    vec = host(vec)
    d = d0 + vec[:, 3:5]
    dctf = vec[:, 5:8] * gate
    return RefineResult(
        rotmat=rot,
        quaternion=_rotmat_to_quaternion(rot),
        cent_x=-d[:, 0],
        cent_y=-d[:, 1],
        pha=pha0 + dctf[:, 0],
        env=np.maximum(env0 + dctf[:, 1], ENV_FLOOR),
        amp=(np.clip(amp0 + dctf[:, 2], AMP_FLOOR, AMP_CEIL).astype(np.float64)
             if refine_ctf_amp else amp0.astype(np.float64)),
        logpro_seed=host(res["lp0"]).astype(np.float64),
        logpro_refined=host(res["lp1"]).astype(np.float64),
        grad_norm=host(res["gnorm"]).astype(np.float64),
        image_chunk=image_chunk,
    )
