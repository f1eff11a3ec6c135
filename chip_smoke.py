#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bioem_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bioem_tpu_torch/csrc`` and drives
the port's main path on the card, in phases (each prints its own lines):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: nvcc of every kernel, with its seconds and ptxas resource lines;
3. kernels vs their plain torch versions at the production shapes
   (bench.py's BASELINE config-2 problem) and one odd shape, with each
   kernel's time beside the plain version's;
4. the reference-binary goldens (tests/golden/data) through the port's CLI;
5. the production-shape posterior run (4352 orientations × 8 CTFs × 64
   images at N=224) through run_bioem on the kernel branch, against the
   plain branch on the same card.

Every kernel's launch counter is set to 0 before phase 4 and read after
phase 5: the main path must have launched each kernel. The line before the
last is a JSON object describing every kernel; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed. Exits non-zero without a result when no CUDA device is present or
when the port's package is not next to this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def say(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# The production problem: bench.py:build_problem's shape, rebuilt with the
# port's host layer and the same seed.
# ---------------------------------------------------------------------------

def build_problem(signal: float = 0.3, n_pix: int = 224, quat_grid: int = 15,
                  n_img: int = 64, max_disp: int = 20):
    """BASELINE config 2 (bench.py:35-77): N=224, 4352 quaternion
    orientations (grid 15), 8 CTFs (4 defocus × 2 B-env), 64 images, D=21
    displacements at stride 2, a 500-point model with PDB residue radii.

    The images are bench.py's seed-0 noise with one planted projection
    each (a known grid orientation, CTF and displacement, at ``signal``
    times the noise level), then normalised per image as the MRC ingest
    does — so the fused f32 comparison applies and the posterior has a
    clear maximum to recover. Returns (p, orients, model, images, planted).
    """
    from bioem_tpu_torch.core.orientations import build_orientations
    from bioem_tpu_torch.io.map_io import ImageStack, _normalize_stack
    from bioem_tpu_torch.io.model_io import AA_DENSITY, AA_RADIUS, Model
    from bioem_tpu_torch.params import BioEMParams

    p = BioEMParams(
        pixel_size=1.06, n_pixels=n_pix, use_quaternions=True,
        grid_points_quaternion=quat_grid, n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=4, start_defocus=0.5, end_defocus=2.5, n_env=2,
        start_bfactor=2.0, end_bfactor=100.0, max_displace_center=max_disp,
        grid_space_center=2,
    ).finalize_ctf_mode()
    orients = build_orientations(p)
    rng = np.random.default_rng(SEED)
    npts = 500
    u = rng.normal(size=(npts, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * 100.0 * min(1.0, n_pix / 320) * rng.uniform(size=(npts, 1)) ** (1 / 3)).astype(np.float32)
    residues = rng.choice(list(AA_RADIUS), npts)
    radii = np.array([AA_RADIUS[r] for r in residues], np.float32)
    dens = np.array([AA_DENSITY[r] for r in residues], np.float32)
    model = Model(pts, radii, dens, float(dens.sum())).center_density_mass()
    noise = rng.normal(0, 1, (n_img, n_pix, n_pix)).astype(np.float32)
    planted = plant(p, orients, model, rng, n_img)
    sig = planted.pop("maps")
    sig = sig / sig.reshape(n_img, -1).std(axis=1)[:, None, None]
    maps = _normalize_stack((noise + signal * sig).astype(np.float32))
    return p, orients, model, ImageStack(maps), planted


def plant(p, orients, model, rng, n_img: int) -> dict:
    """Noise-free images of the model: per image a random grid orientation,
    CTF and lattice displacement, made with the port's plain projection."""
    import torch

    from bioem_tpu_torch.core.ctf import build_ctf_bank
    from bioem_tpu_torch.core.orientations import rotation_matrices
    from bioem_tpu_torch.core.projection import (
        make_fourier_projection_spec, project_fourier_batch,
    )
    from bioem_tpu_torch.params import displacement_lists, make_ctf_grid

    n = p.n_pixels
    grid = make_ctf_grid(p)
    bank = build_ctf_bank(p, grid)
    disp, _ = displacement_lists(p)
    fspec, gidx, pmask, st, st_sums = make_fourier_projection_spec(p, model.radii)
    o_idx = rng.integers(0, orients.n, n_img)
    c_idx = rng.integers(0, grid.n, n_img)
    dx = disp[rng.integers(0, len(disp), n_img)]
    dy = disp[rng.integers(0, len(disp), n_img)]
    t = torch.as_tensor
    rotm = rotation_matrices(t(orients.angles[o_idx]), True)
    pr, pi = project_fourier_batch(
        fspec, rotm, t(model.points[gidx]), t(model.radii[gidx]),
        t(model.densities[gidx] * pmask), t(np.float32(model.norm_den)),
        t(np.ascontiguousarray(st.real)), t(np.ascontiguousarray(st.imag)), t(st_sums),
    )
    spec = (pr.numpy() + 1j * pi.numpy()) * np.conj(bank[c_idx])
    maps = np.fft.irfft2(spec, s=(n, n))
    maps = np.stack([np.roll(m, (int(a), int(b)), axis=(0, 1)) for m, a, b in zip(maps, dx, dy)])
    return dict(maps=maps.astype(np.float32), orient=o_idx, ctf=c_idx, dx=dx, dy=dy)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment(torch) -> str:
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(q.returncode == 0 and q.stdout.strip(), f"nvidia-smi failed: {q.stderr}")
    card = q.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} card(s): "
        f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> None:
    from bioem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load(verbose=True)
    info = _build.build_info
    say(f"[build] {os.path.relpath(info['path'], HERE)} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s, "
        f"cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if "Used" in line or "spill" in line:
            say(f"[build] {line.strip()}")


def _block_inputs(eng, b: int = 0):
    """The kernel branch's inputs for orientation block ``b`` of an engine,
    from the plain projection (so a kernel is compared on inputs no kernel
    made)."""
    from bioem_tpu_torch.core.engine import fused_coefficients
    from bioem_tpu_torch.core.orientations import rotation_matrices
    from bioem_tpu_torch.core.posterior import ctf_prior_term
    from bioem_tpu_torch.core.projection import grouped_snap, project_fourier_batch

    bk, p, fs = eng.banks, eng.p, eng.fspec
    rotm = rotation_matrices(eng.ang_blocks[b], eng.orients.use_quaternions)
    model = (bk.points, bk.radii, bk.dens)
    pr, pi = project_fourier_batch(fs, rotm, *model, bk.norm_den, bk.st_re, bk.st_im, bk.st_sums)
    i0, j0, de = grouped_snap(fs, rotm, *model)
    prior = ctf_prior_term(bk.amp, bk.pha, bk.env, p)[None].expand(eng.o_block, eng.n_ctf)
    sum_c, _ssq_c, f0, _k = eng._kernel_constants(bk, pr, pi, prior)
    a_u, b_u = fused_coefficients(f0, sum_c, bk.sum_ref, p.n_total_pixels)
    m = p.n_pixels // eng.n_fold
    return dict(
        pr=pr, pi=pi, i0=i0, j0=j0, dens=de, a_u=a_u, b_u=b_u,
        wx_re=bk.wx_re[:, :m].contiguous(), wx_im=bk.wx_im[:, :m].contiguous(),
        a_coef=(3.0 - p.n_total_pixels) * 0.5,
    )


def check_compare(torch, name, args, a_coef, n_fold):
    """K1 against its plain version on the card; returns max |Δm|."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod

    kern = cc_mod.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)
    plain = cc_mod.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    torch.cuda.synchronize()
    km, ks, kd, kc = kern
    pm, ps, pd, pc = plain
    require(all(bool(torch.isfinite(x).all()) for x in (km, ks, kc, pm, ps, pc)),
            f"{name}: non-finite output")
    # near-ties: the plain version's two best v within 1e-5·|a_coef|
    o_n, c_n = args[0].shape[0], args[2].shape[0]
    conv_re = args[0][:, None] * args[2][None] + args[1][:, None] * args[3][None]
    conv_im = args[1][:, None] * args[2][None] - args[0][:, None] * args[3][None]
    n, f = args[0].shape[1:]
    cc = cc_mod.displacement_cc_plain(
        conv_re.reshape(o_n * c_n, n, f), conv_im.reshape(o_n * c_n, n, f),
        *args[4:10], n_fold=n_fold,
    ).flatten(2)
    v = a_coef * torch.log1p(args[10][..., None] * cc - args[11][..., None] * cc * cc)
    top2 = torch.topk(v, 2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1e-5 * abs(a_coef)
    m_rel = float(((km - pm).abs() / pm.abs().clamp_min(1e-30)).max())
    s_rel = float(((ks - ps).abs() / ps.abs()).max())
    # Both versions against an f64 log-sum-exp on the first images: se
    # carries v's ABSOLUTE f32 error (≈ |v|·1e-6 from the cc rounding), so
    # its kernel-vs-plain spread exceeds 1e-5 at production N; what must
    # hold is that the kernel is as close to f64 as the plain version.
    ni = min(4, args[4].shape[0])
    dbl = [a.double() for a in args[4:10]]
    cc64 = cc_mod.displacement_cc_plain(
        conv_re.reshape(o_n * c_n, n, f).double(), conv_im.reshape(o_n * c_n, n, f).double(),
        dbl[0][:ni], dbl[1][:ni], *dbl[2:], n_fold=n_fold,
    ).flatten(2)
    v64 = a_coef * torch.log1p(args[10][:, :ni, None].double() * cc64
                               - args[11][:, :ni, None].double() * cc64 * cc64)
    lse64 = torch.logsumexp(v64, dim=-1)
    k_lse = float((km[:, :ni].double() + ks[:, :ni].double().log() - lse64).abs().max())
    p_lse = float((pm[:, :ni].double() + ps[:, :ni].double().log() - lse64).abs().max())
    ds_bad = int(((kd != pd) & ~tie).sum())
    ccs_rel = float(((kc - pc).abs() / pc.abs().clamp_min(1e-30))[(kd == pd)].max())
    say(f"[kernels] {name}: max rel |Δm| {m_rel:.2e}, |Δse| {s_rel:.2e}, "
        f"argmax mismatches off near-ties {ds_bad}, near-ties {int(tie.sum())}, "
        f"max rel |Δccs| at equal argmax {ccs_rel:.2e}; |m + log se − f64 LSE| "
        f"kernel {k_lse:.2e}, plain {p_lse:.2e}")
    require(m_rel <= 1e-5, f"{name}: m beyond rtol 1e-5")
    require(s_rel <= 1.5e-4, f"{name}: se beyond rtol 1.5e-4")
    require(k_lse <= 4 * p_lse + 1e-6, f"{name}: kernel LSE further from f64 than 4x plain")
    require(ds_bad == 0, f"{name}: argmax differs away from near-ties")
    require(ccs_rel <= 1e-5, f"{name}: cc at the argmax beyond rtol 1e-5")
    return float((km - pm).abs().max())


def check_cc(torch, name, conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im,
             n_fold, n_ref_img):
    """K3 against an f64 NumPy lattice on the first ``n_ref_img`` images."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod

    out = cc_mod.fused_displacement_cc(
        conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, n_fold=n_fold
    )
    torch.cuda.synchronize()
    h = lambda x: x.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    n = conv_re.shape[1]
    m = wx_re.shape[1]
    conv = h(conv_re) + 1j * h(conv_im)
    img = (h(img_re) + 1j * h(img_im))[:n_ref_img]
    pfull = conv[:, None] * img[None]  # (OC, i, N, F)
    pf = pfull.reshape(*pfull.shape[:2], n_fold, m, pfull.shape[-1]).sum(axis=2)
    wx = h(wx_re) + 1j * h(wx_im)
    wy = h(wy_re) + 1j * h(wy_im)
    t1 = np.matmul(wx, pf)  # (OC, i, D, F)
    ref = np.matmul(t1, wy.T).real
    got = h(out)[:, :n_ref_img]
    err = float(np.abs(got - ref).max())
    rel = err / float(np.abs(ref).max())
    say(f"[kernels] {name}: max |Δcc| {err:.3e} = {rel:.2e} of max|cc| vs f64 "
        f"({n_ref_img} of {img_re.shape[0]} images)")
    require(rel < 5e-5, f"{name}: cc beyond 5e-5 relative")
    return err


def check_project(torch, name, i0, j0, dens, st_re, st_im, n):
    from bioem_tpu_torch.ops import project_cuda as pj

    kr, ki = pj.fourier_project_block(i0, j0, dens, st_re, st_im, n=n)
    pr, pi = pj.fourier_project_block_plain(i0, j0, dens, st_re, st_im, n=n)
    torch.cuda.synchronize()
    err = float(max((kr - pr).abs().max(), (ki - pi).abs().max()))
    rel = err / float(max(pr.abs().max(), pi.abs().max()))
    say(f"[kernels] {name}: max |Δ| {err:.3e} = {rel:.2e} of max|spectrum|")
    require(rel < 5e-5, f"{name}: projection beyond 5e-5 relative")
    return err


def phase_kernels(torch, eng) -> dict:
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import project_cuda as pj

    dev = eng.device
    bk = eng.banks
    x = _block_inputs(eng)
    k1_args = (x["pr"], x["pi"], bk.ctf_re, bk.ctf_im, bk.img_re, bk.img_im,
               x["wx_re"], x["wx_im"], bk.wy_re, bk.wy_im, x["a_u"], x["b_u"])
    o, c, n, f = eng.o_block, eng.n_ctf, eng.p.n_pixels, eng.p.n_fft_1d
    say(f"[kernels] production shapes: O={o} C={c} I={bk.img_re.shape[0]} N={n} F={f} "
        f"D={eng.disp.shape[0]} n_fold={eng.n_fold} G={eng.fspec.n_groups} "
        f"Pp={eng.fspec.group_pad}")
    err1 = check_compare(torch, "K1 fused_compare_block", k1_args, x["a_coef"], eng.n_fold)
    conv_re = (x["pr"][:, None] * bk.ctf_re[None] + x["pi"][:, None] * bk.ctf_im[None]).reshape(o * c, n, f)
    conv_im = (x["pi"][:, None] * bk.ctf_re[None] - x["pr"][:, None] * bk.ctf_im[None]).reshape(o * c, n, f)
    k3_args = (conv_re, conv_im, bk.img_re, bk.img_im, x["wx_re"], x["wx_im"], bk.wy_re, bk.wy_im)
    err3 = check_cc(torch, "K3 fused_displacement_cc", *k3_args, eng.n_fold, 4)
    k2_args = (x["i0"], x["j0"], x["dens"], bk.st_re, bk.st_im)
    err2 = check_project(torch, "K2 fourier_project_block", *k2_args, n)

    # odd shape: N=15, n_fold=1, D=5 from a numpy seed
    rng = np.random.default_rng(SEED)
    on, cn, inn, nn, dd = 3, 2, 5, 15, 5
    fn = nn // 2 + 1
    r = lambda *s: torch.as_tensor(rng.normal(0, 1, s).astype(np.float32), device=dev)  # noqa: E731
    from bioem_tpu_torch.core.posterior import displacement_dft_weights

    wx, wy = displacement_dft_weights(nn, np.arange(-2, 3))
    w = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
         for a in (wx.real, wx.imag, wy.real, wy.imag)]
    au = torch.as_tensor(np.abs(rng.normal(0, 1e-4, (on * cn, inn))).astype(np.float32), device=dev)
    bu = torch.as_tensor(np.abs(rng.normal(0, 1e-6, (on * cn, inn))).astype(np.float32), device=dev)
    odd = (r(on, nn, fn), r(on, nn, fn), r(cn, nn, fn), r(cn, nn, fn), r(inn, nn, fn),
           r(inn, nn, fn), *w, au, bu)
    check_compare(torch, "K1 odd N=15 D=5", odd, -111.0, 1)
    check_cc(torch, "K3 odd N=15 D=5", r(6, nn, fn), r(6, nn, fn), odd[4], odd[5], *w, 1, inn)
    gi = lambda *s: torch.as_tensor(rng.integers(-20, 40, s).astype(np.int32), device=dev)  # noqa: E731
    check_project(torch, "K2 odd N=15", gi(3, 4, 8), gi(3, 4, 8), r(3, 4, 8).abs(),
                  r(3, nn, fn), r(3, nn, fn), nn)

    # times at the production shapes, kernel beside plain version
    t = {}
    t["K1"] = (time_ms(torch, lambda: cc_mod.fused_compare_block(*k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold)),
               time_ms(torch, lambda: cc_mod.fused_compare_block_plain(*k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold), 3))
    t["K3"] = (time_ms(torch, lambda: cc_mod.fused_displacement_cc(*k3_args, n_fold=eng.n_fold)),
               time_ms(torch, lambda: cc_mod.displacement_cc_plain(*k3_args, n_fold=eng.n_fold), 3))
    t["K2"] = (time_ms(torch, lambda: pj.fourier_project_block(*k2_args, n=n)),
               time_ms(torch, lambda: pj.fourier_project_block_plain(*k2_args, n=n), 3))
    for k, (a, b) in t.items():
        say(f"[kernels] {k} production-shape time: kernel {a:.3f} ms, plain {b:.3f} ms")
    return {
        "K1": dict(name="fused_compare_block", route="cuda",
                   source="bioem_tpu_torch/csrc/compare.cu",
                   replaces="bioem_tpu/ops/compare_pallas.py:301",
                   max_abs_err=err1, ms=t["K1"][0], plain_ms=t["K1"][1]),
        "K2": dict(name="fourier_project_block", route="cuda",
                   source="bioem_tpu_torch/csrc/project.cu",
                   replaces="bioem_tpu/ops/project_pallas.py:70",
                   max_abs_err=err2, ms=t["K2"][0], plain_ms=t["K2"][1]),
        "K3": dict(name="fused_displacement_cc", route="cuda",
                   source="bioem_tpu_torch/csrc/compare.cu",
                   replaces="bioem_tpu/ops/compare_pallas.py:643",
                   max_abs_err=err3, ms=t["K3"][0], plain_ms=t["K3"][1]),
    }


def phase_goldens() -> None:
    sys.path.insert(0, HERE)
    from tests.test_golden import CASE_ATOL, CASES, DATA, F64_CASES, LOGP_ATOL, parse_output
    from bioem_tpu_torch.cli import main

    runs = [(c, "Output_Probabilities.golden") for c in sorted(CASES)]
    runs += [(c, "Output_Probabilities.f64.golden") for c in F64_CASES]
    for case, golden in runs:
        model_file, maps_file, extra, _has_ang, n_ang, centers_exact = CASES[case]
        f64 = "f64" in golden
        atol = 2e-3 if f64 else CASE_ATOL.get(case, LOGP_ATOL)
        with tempfile.TemporaryDirectory() as work:
            shutil.copytree(os.path.join(DATA, case), work, dirs_exist_ok=True)
            old = os.getcwd()
            os.chdir(work)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = main(["--Modelfile", model_file, "--Particlesfile", maps_file,
                               "--Inputfile", "param.txt", "--OutputFile", "out", *extra])
            finally:
                os.chdir(old)
            require(rc == 0, f"golden {case}: CLI returned {rc}")
            lp_t, _, par_t = parse_output(open(os.path.join(work, "out")).read())
            lp_g, _, par_g = parse_output(open(os.path.join(work, golden)).read())
        require(len(lp_t) == len(lp_g) > 0, f"golden {case}: image count")
        d = float(np.max(np.abs(lp_t - lp_g)))
        ok = d <= atol
        for pt, pg in zip(par_t, par_g):
            ok &= bool(np.allclose(pt[1: n_ang + 4], pg[1: n_ang + 4], atol=1e-3 if not f64 else 1e-4))
            if centers_exact or f64:
                ok &= pt[n_ang + 4: n_ang + 6] == pg[n_ang + 4: n_ang + 6]
        say(f"[goldens] {case}{' (f64 truth)' if f64 else ''}: max |ΔlogP| {d:.2e} "
            f"(atol {atol:g}) {'ok' if ok else 'FAIL'}")
        require(ok, f"golden {case} vs {golden} out of tolerance")


def phase_production(problem) -> None:
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, planted = problem
    before = (cc_mod.fused_compare_block.launches, pj.fourier_project_block.launches)
    res_k, perf_k = run_bioem(p, orients, model, images, RunConfig(use_kernels=True), device="cuda")
    n_k1 = cc_mod.fused_compare_block.launches - before[0]
    n_k2 = pj.fourier_project_block.launches - before[1]
    cmp = perf_k["comparisons"]
    say(f"[production] kernel branch: {perf_k['run_s']:.3f} s, "
        f"{perf_k['comparisons_per_s']:.4e} comparisons/s ({cmp} comparisons; "
        f"K1 launches {n_k1}, K2 launches {n_k2})")
    require(n_k1 > 0 and n_k2 > 0, "production run did not launch K1 and K2")
    require(bool(np.isfinite(res_k.log_prob).all()), "non-finite logP on the kernel branch")
    res_p, perf_p = run_bioem(
        p, orients, model, images, RunConfig(use_kernels=False), device="cuda"
    )
    say(f"[production] plain branch: {perf_p['run_s']:.3f} s, "
        f"{perf_p['comparisons_per_s']:.4e} comparisons/s")
    require(bool(np.isfinite(res_p.log_prob).all()), "non-finite logP on the plain branch")
    fields = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")
    same = np.all([getattr(res_k, f) == getattr(res_p, f) for f in fields], axis=0)
    dlp = float(np.max(np.abs(res_k.log_prob - res_p.log_prob)))
    # q and −q are the same rotation and both lie on the quaternion grid, so
    # recovery compares rotation matrices, not grid indices.
    import torch

    from bioem_tpu_torch.core.orientations import rotation_matrices

    def rot(idx):
        return rotation_matrices(torch.as_tensor(orients.angles[idx]), orients.use_quaternions)

    same_rot = (rot(res_k.best_orient) - rot(planted["orient"])).abs().amax(dim=(1, 2)) < 1e-5
    rec = float(same_rot.float().mean())
    rec_c = float(np.mean(res_k.best_conv == planted["ctf"]))
    say(f"[production] argmax tuples equal on {int(same.sum())}/{len(same)} images; "
        f"max |ΔlogP| kernel vs plain {dlp:.3e}; planted orientation recovered "
        f"{rec:.3f}, planted CTF {rec_c:.3f}")
    require(bool(same.all()), "argmax tuples differ between kernel and plain branch")
    require(rec >= 0.9, "planted orientations not recovered")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bioem_tpu_torch")):
        print("chip_smoke: bioem_tpu_torch/ is not next to this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    try:
        phase_environment(torch)
        phase_build()

        from bioem_tpu_torch.config import RunConfig
        from bioem_tpu_torch.core.engine import BioEMEngine
        from bioem_tpu_torch.ops import compare_cuda as cc_mod
        from bioem_tpu_torch.ops import project_cuda as pj

        t0 = time.perf_counter()
        problem = build_problem()
        p, orients, model, images, _ = problem
        eng = BioEMEngine(p, orients, model, images, RunConfig(), device="cuda")
        require(eng.fspec is not None and eng._f32_corr_ok,
                "production problem must take the Fourier projection and the fused comparison")
        say(f"[setup] production problem: {orients.n} orientations × {eng.n_ctf} CTFs × "
            f"{eng.n_img} images, {model.n_points} points in {eng.fspec.n_groups} radius "
            f"groups, set up in {time.perf_counter() - t0:.1f} s")
        rows = phase_kernels(torch, eng)
        del eng

        counters = {"K1": cc_mod.fused_compare_block, "K2": pj.fourier_project_block,
                    "K3": cc_mod.fused_displacement_cc}
        for fn in counters.values():
            fn.launches = 0
        phase_goldens()
        phase_production(problem)
        for k, fn in counters.items():
            rows[k]["launches"] = fn.launches
        say(f"[main path] launches: " + ", ".join(f"{k} {fn.launches}" for k, fn in counters.items()))
        require(all(fn.launches > 0 for fn in counters.values()),
                "a kernel of the main path was never launched")
    except Exception as e:  # every phase failure ends the run with a nonzero code
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"[done] chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [dict(name=r["name"], route=r["route"], source=r["source"],
                                     replaces=r["replaces"], launches=r["launches"],
                                     max_abs_err=r["max_abs_err"], ms=r["ms"],
                                     plain_ms=r["plain_ms"])
                                for r in (rows["K1"], rows["K2"], rows["K3"])]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
