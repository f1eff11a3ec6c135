#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bioem_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bioem_tpu_torch/csrc`` and drives
the port's main path on the card, in phases (each prints its own lines):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: nvcc of every kernel, with its seconds and ptxas resource lines
   (each kernel's registers, spills and static shared memory);
3. kernels vs their plain torch versions at the production shapes
   (bench.py's BASELINE config-2 problem) and one odd shape, with each
   kernel's time beside the plain version's; the per-image comparison
   (K1) launched twice and held to the same bits, and at the shapes K4
   does not take (D = 35, a stride-1 lattice at N = 224) and fold counts
   3 and 4; the image-batched comparison (K4) at the image tile the
   production passes run, launched twice and once at tile 8, all held to
   the same bits, and at lattice strides that fold the rows three and four
   times; the cc-lattice kernel (K3, K1's kernel writing the lattice)
   against an f64 lattice at the production shapes, at N = 15 and on the
   stride-1 ±30 lattice at N = 224 (D = 61, M = 224), and twice to the
   same bits;
4. the reference-binary goldens (tests/golden/data) through the port's CLI;
5. the production-shape posterior run (4352 orientations × 8 CTFs × 64
   images at N=224) through run_bioem: on the kernel branch with K1 (then
   32 of its blocks as the eager loop and as replays of the captured
   block step, each timed and under torch.profiler: wall time and the
   card's busy share), with K4 forced (BIOEM_TPU_FUSED_BATCHED), and
   autotuned three times from an empty cache and once more from the cache
   (each candidate's time on its replayed loop, each winner and its pass
   time printed; each pass with the seconds its tuning took; the autotune
   cache is a temporary file, never the working directory's), each against
   the plain branch on the same card; then a checkpoint round trip (stop
   after half the blocks, resume under replay in a fresh engine) against
   the straight run;
6. the kernel probe tool (bioem_tpu_torch.tools.kernel_probe): P1 (the
   f32 product's accuracy and time by scheme), P2 (looped vs batched
   products on wgmma across the card, beside one cuBLAS GEMM doing all
   of them) and P3 (the K1/K4 body ablation at the production block),
   each held to its check;
7. --PrintBestCalMap on golden case M through the port's CLI, held to
   tests/test_golden.py's BESTMAP rule;
8. DEBUG_PROB: golden case L (N=64) through the port's CLI twice, dumping
   one image on the plain branch and through K3, diffed with the port's
   diff entry point, and the dump's log-sum-exp held to the image's logP.

The paths are driven in parts, each with every kernel's launch counter
set to 0 just before it and read just after: the goldens with the plain
and K1 passes must launch K1, K2 and K3; the K4, autotuned and checkpoint
passes K2 and K4; the probe tool P1, P2 and P3; the DEBUG_PROB runs K3.
The line before the last is a JSON object describing every kernel, with
its launches on those paths, its time beside its plain version's, the
least time the card could take for the same work (``bound_ms``, from the
shapes of this run's inputs and the H100 peaks below) and, where one
PyTorch call computes the same function, that call's time; the last line
is ``{"ok": true, "device": {...}}`` and is printed only when every phase
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
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"


# Published dense peaks of one H100 SXM (NVIDIA's data sheet) and its
# memory rate, for bound_ms.
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def say(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def bound(ops: dict, nbytes: float) -> tuple:
    """(ms, "operations" | "bytes"): the larger of the operations over the
    peak of their type (``ops`` = {type: count}, summed) and the bytes
    (each input read once, each output written once) over HBM's rate."""
    t_ops = sum(n / PEAK[ty] for ty, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare_work(o, c, i, n, f, d, m, n_fold, conv_in: bool = False) -> dict:
    """Useful f32 operations of one comparison block, split into stage 1
    (t1 = wx·p, 8·D·M·F per comparison: K4 runs it on the tensor cores)
    and the rest: conv = proj ⊙ conj(ctf) once per (o, c) unless conv is
    an input (K3), p = conv ⊙ img (6·N·F) and its fold, stage 2
    cc = Re(t1·wyᵀ) (4·D²·F), and the log-sum-exp (8 per lattice point,
    a transcendental counted as one operation)."""
    cmp = o * c * i
    stage1 = 8 * d * m * f * cmp
    rest = (0 if conv_in else 6 * o * c * n * f) + cmp * (
        6 * n * f + 2 * (n_fold - 1) * m * f + 4 * d * d * f + (0 if conv_in else 8 * d * d))
    return {"stage1": stage1, "rest": rest}


def compare_bound(o, c, i, n, f, d, m, n_fold, tensor_cores: bool = False) -> tuple:
    """K1's (f32 FMA) or K4's (stage 1 in 3xTF32 on the tensor cores)
    bound: spectra, weights and a_u/b_u read once, four (O·C, I) outputs."""
    w = compare_work(o, c, i, n, f, d, m, n_fold)
    ops = ({"tf32": 3 * w["stage1"], "f32": w["rest"]} if tensor_cores
           else {"f32": w["stage1"] + w["rest"]})
    nbytes = 4 * (2 * (o + c + i) * n * f + 2 * d * m + 2 * d * f + 2 * o * c * i + 4 * o * c * i)
    return bound(ops, nbytes)


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
        if ("entry function" in line or "Used" in line or "spill" in line
                or "wgmma" in line or "warning" in line.lower()):
            say(f"[build] {line.strip()}")


def _block_inputs(eng, b: int = 0):
    """The kernel branch's inputs for orientation block ``b`` of an engine,
    from the plain projection (so a kernel is compared on inputs no kernel
    made)."""
    import torch

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
        counts=torch.tensor(fs.group_counts, dtype=torch.int32, device=de.device),
        wx_re=bk.wx_re[:, :m].contiguous(), wx_im=bk.wx_im[:, :m].contiguous(),
        a_coef=(3.0 - p.n_total_pixels) * 0.5,
    )


def check_compare(torch, name, args, a_coef, n_fold, img_tile=None):
    """K1 (or K4 at ``img_tile``) against their plain version on the card;
    returns max |Δm|."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod

    if img_tile is None:
        kern = cc_mod.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)
    else:
        kern = cc_mod.fused_compare_block_batched(*args, a_coef=a_coef, n_fold=n_fold,
                                                  img_tile=img_tile)
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


def check_project(torch, name, i0, j0, dens, st_re, st_im, n, counts, plain_counts):
    """K2 given ``counts`` against its plain version given ``plain_counts``
    (None: every slot, so the check also covers which slots K2 skips)."""
    from bioem_tpu_torch.ops import project_cuda as pj

    kr, ki = pj.fourier_project_block(i0, j0, dens, st_re, st_im, n=n, counts=counts)
    pr, pi = pj.fourier_project_block_plain(i0, j0, dens, st_re, st_im, n=n, counts=plain_counts)
    torch.cuda.synchronize()
    err = float(max((kr - pr).abs().max(), (ki - pi).abs().max()))
    rel = err / float(max(pr.abs().max(), pi.abs().max()))
    say(f"[kernels] {name}: max |Δ| {err:.3e} = {rel:.2e} of max|spectrum|")
    require(rel < 5e-5, f"{name}: projection beyond 5e-5 relative")
    return err


def phase_kernels(torch, eng) -> dict:
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.tools.kernel_probe import device_ms, time_ms  # CUDA events

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
    runs = [cc_mod.fused_compare_block(*k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    say(f"[kernels] K1: two launches bit-equal: {same}")
    require(same, "K1: two launches on the same inputs differ")
    del runs
    # K4 at the tile every production pass runs it at (the default tile:
    # the autotuner does not search K4's tile, whose work it does not
    # change), held to its plain version; then two launches at that tile
    # and one at tile 8 (the tile of earlier measurements) must give the
    # same bits: a fixed order of adds (no atomics), the tile only a
    # contract.
    from bioem_tpu_torch.config import RunConfig

    k4_tile = min(RunConfig().kernel_img_tile, eng.n_img)
    err4 = check_compare(torch, f"K4 fused_compare_block_batched tile {k4_tile}", k1_args,
                         x["a_coef"], eng.n_fold, img_tile=k4_tile)
    runs = [cc_mod.fused_compare_block_batched(*k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold,
                                               img_tile=t) for t in (k4_tile, k4_tile, 8)]
    same = [all(torch.equal(a, b) for a, b in zip(runs[0], r)) for r in runs[1:]]
    say(f"[kernels] K4 tile {k4_tile}: two launches bit-equal: {same[0]}; "
        f"tile 8 bit-equal to it: {same[1]}")
    require(same[0], f"K4 tile {k4_tile}: two launches on the same inputs differ")
    require(same[1], f"K4: tile 8 differs from tile {k4_tile}")
    del runs
    conv_re = (x["pr"][:, None] * bk.ctf_re[None] + x["pi"][:, None] * bk.ctf_im[None]).reshape(o * c, n, f)
    conv_im = (x["pi"][:, None] * bk.ctf_re[None] - x["pr"][:, None] * bk.ctf_im[None]).reshape(o * c, n, f)
    k3_args = (conv_re, conv_im, bk.img_re, bk.img_im, x["wx_re"], x["wx_im"], bk.wy_re, bk.wy_im)
    err3 = check_cc(torch, "K3 fused_displacement_cc", *k3_args, eng.n_fold, 4)
    runs = [cc_mod.fused_displacement_cc(*k3_args, n_fold=eng.n_fold) for _ in range(2)]
    same = torch.equal(*runs)
    say(f"[kernels] K3: two launches bit-equal: {same}")
    require(same, "K3: two launches on the same inputs differ")
    del runs
    k2_args = (x["i0"], x["j0"], x["dens"], bk.st_re, bk.st_im)
    # the spec's counts against every slot: the padding holds zero density
    err2 = check_project(torch, "K2 fourier_project_block", *k2_args, n, x["counts"], None)

    # odd shape: N=15, n_fold=1, D=5 from a numpy seed
    rng = np.random.default_rng(SEED)
    r = lambda *s: torch.as_tensor(rng.normal(0, 1, s).astype(np.float32), device=dev)  # noqa: E731
    from bioem_tpu_torch.core.posterior import displacement_dft_weights

    def small_inputs(on, cn, inn, nn, disp):
        """Random comparison inputs at (O, C, I, N) on the lattice ``disp``;
        a_u, b_u shrink with N as cc grows (kernel_probe's production block
        uses 1e-6 and 1e-9 at N = 224), so that u stays above −1."""
        au_sd, bu_sd = (1e-4, 1e-6) if nn < 128 else (1e-6, 1e-9)
        fn = nn // 2 + 1
        n_fold = int(np.gcd.reduce(np.append(np.abs(disp), nn)))
        wx, wy = displacement_dft_weights(nn, np.asarray(disp))
        w = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
             for a in (wx.real[:, :nn // n_fold], wx.imag[:, :nn // n_fold], wy.real, wy.imag)]
        au = torch.as_tensor(np.abs(rng.normal(0, au_sd, (on * cn, inn))).astype(np.float32),
                             device=dev)
        bu = torch.as_tensor(np.abs(rng.normal(0, bu_sd, (on * cn, inn))).astype(np.float32),
                             device=dev)
        return (r(on, nn, fn), r(on, nn, fn), r(cn, nn, fn), r(cn, nn, fn), r(inn, nn, fn),
                r(inn, nn, fn), *w, au, bu), n_fold

    odd, _ = small_inputs(3, 2, 5, 15, np.arange(-2, 3))
    check_compare(torch, "K1 odd N=15 D=5", odd, -111.0, 1)
    # K1 where K4 has no instance or W does not fit (D = 35; D = 21 on a
    # stride-1 lattice at N = 224, M = 224), and at folds 3 and 4
    for on, cn, inn, nn, disp in ((2, 2, 6, 48, np.arange(-17, 18)),
                                  (2, 2, 6, 224, np.arange(-10, 11)),
                                  (2, 3, 5, 48, 3 * np.arange(-4, 5)),
                                  (2, 3, 5, 64, 4 * np.arange(-4, 5))):
        args, nf_ = small_inputs(on, cn, inn, nn, disp)
        check_compare(torch, f"K1 N={nn} D={len(disp)} n_fold={nf_}", args, -0.5 * nn * nn, nf_)
    for t in (1, 5):
        check_compare(torch, f"K4 odd N=15 D=5 tile {t}", odd, -111.0, 1, img_tile=t)
    # K4 where the stride folds the rows three and four times (its folds
    # past the second take their own path)
    for nn, s in ((48, 3), (64, 4)):
        args, n_fold = small_inputs(2, 3, 16, nn, s * np.arange(-4, 5))
        require(n_fold == s, f"the lattice at stride {s} folds {n_fold} times")
        check_compare(torch, f"K4 N={nn} D=9 n_fold={s} tile 8", args, -0.5 * nn * nn, s,
                      img_tile=8)
    w = odd[6:10]
    check_cc(torch, "K3 odd N=15 D=5", r(6, 15, 8), r(6, 15, 8), odd[4], odd[5], *w, 1, 5)
    # K3 on the stride-1 ±30 lattice at N = 224 (D = 61, M = 224), which the
    # earlier K3 refused for its shared memory
    wide, nf_ = small_inputs(1, 1, 5, 224, np.arange(-30, 31))
    check_cc(torch, f"K3 N=224 D=61 n_fold={nf_}", r(4, 224, 113), r(4, 224, 113), wide[4],
             wide[5], *wide[6:10], nf_, 5)
    gi = lambda *s: torch.as_tensor(rng.integers(-20, 40, s).astype(np.int32), device=dev)  # noqa: E731
    odd_counts = torch.tensor([8, 0, 3], dtype=torch.int32, device=dev)
    check_project(torch, "K2 odd N=15", gi(3, 4, 8), gi(3, 4, 8), r(3, 4, 8).abs(),
                  r(3, 15, 8), r(3, 15, 8), 15, odd_counts, odd_counts)

    # times at the production shapes, kernel beside plain version
    t = {}
    t["K1"] = (time_ms(lambda: cc_mod.fused_compare_block(*k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold)),
               time_ms(lambda: cc_mod.fused_compare_block_plain(*k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold), 3))
    t["K3"] = (time_ms(lambda: cc_mod.fused_displacement_cc(*k3_args, n_fold=eng.n_fold)),
               time_ms(lambda: cc_mod.displacement_cc_plain(*k3_args, n_fold=eng.n_fold), 3))
    # K2's launch is shorter than its wrapper's host time: the card's own time
    t["K2"] = (device_ms(lambda: pj.fourier_project_block(*k2_args, n=n, counts=x["counts"])),
               time_ms(lambda: pj.fourier_project_block_plain(*k2_args, n=n,
                                                              counts=x["counts"]), 3))
    t["K4"] = (time_ms(lambda: cc_mod.fused_compare_block_batched(
        *k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold, img_tile=k4_tile)), t["K1"][1])
    for k, (a, b) in t.items():
        say(f"[kernels] {k} production-shape time: kernel {a:.3f} ms, plain {b:.3f} ms")

    # Bounds from this block's shapes, each for the least time the card
    # could take on its tensor cores at f32 accuracy (3xTF32 products).
    # K2 counts the model's points (the zero-density group padding is work
    # the data does not need): its group product, 8 per point-frequency,
    # three TF32 passes, and the Ŝ epilogue in f32.
    i_n, d, m = bk.img_re.shape[0], eng.disp.shape[0], n // eng.n_fold
    b1 = compare_bound(o, c, i_n, n, f, d, m, eng.n_fold, tensor_cores=True)
    b4 = b1
    # K3: stage 1 on the tensor cores as K1's; conv and images read once,
    # the lattice written once
    w3 = compare_work(o, c, i_n, n, f, d, m, eng.n_fold, conv_in=True)
    b3 = bound({"tf32": 3 * w3["stage1"], "f32": w3["rest"]},
               4 * (2 * (o * c + i_n) * n * f + 2 * d * m + 2 * d * f + o * c * i_n * d * d))
    g = x["i0"].shape[0]
    n_pts = int((x["dens"] != 0).sum())
    b2 = bound({"tf32": 3 * 8 * n_pts * n * f, "f32": 8 * g * o * n * f},
               4 * (3 * x["i0"].numel() + 2 * g * n * f + 2 * o * n * f))
    for k, b in (("K1", b1), ("K2", b2), ("K3", b3), ("K4", b4)):
        say(f"[kernels] {k} bound {b[0]:.4f} ms ({b[1]}-bound)")
    none = dict(library_ms=None)  # no single PyTorch call computes K1–K4
    return {
        "K1": dict(name="fused_compare_block", route="cuda",
                   source="bioem_tpu_torch/csrc/compare_fused.cu",
                   replaces="bioem_tpu/ops/compare_pallas.py:301",
                   max_abs_err=err1, ms=t["K1"][0], plain_ms=t["K1"][1],
                   bound_ms=b1[0], bound_by=b1[1], **none),
        "K2": dict(name="fourier_project_block", route="cuda",
                   source="bioem_tpu_torch/csrc/project.cu",
                   replaces="bioem_tpu/ops/project_pallas.py:70",
                   max_abs_err=err2, ms=t["K2"][0], plain_ms=t["K2"][1],
                   bound_ms=b2[0], bound_by=b2[1], **none),
        "K3": dict(name="fused_displacement_cc", route="cuda",
                   source="bioem_tpu_torch/csrc/compare_fused.cu",
                   replaces="bioem_tpu/ops/compare_pallas.py:643",
                   max_abs_err=err3, ms=t["K3"][0], plain_ms=t["K3"][1],
                   bound_ms=b3[0], bound_by=b3[1], **none),
        "K4": dict(name="fused_compare_block_batched", route="cuda",
                   source="bioem_tpu_torch/csrc/compare_batched.cu",
                   replaces="bioem_tpu/ops/compare_pallas.py:367",
                   max_abs_err=err4, ms=t["K4"][0],
                   plain_ms=t["K1"][1], tile=k4_tile, bound_ms=b4[0], bound_by=b4[1], **none),
    }


@contextlib.contextmanager
def _in_case(case: str, env: dict):
    """A temporary copy of golden case ``case`` as the working directory,
    with ``env`` set; both undone on exit."""
    sys.path.insert(0, HERE)
    from tests.test_golden import DATA

    saved = {k: os.environ.get(k) for k in env}
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        shutil.copytree(os.path.join(DATA, case), work, dirs_exist_ok=True)
        os.environ.update(env)
        os.chdir(work)
        try:
            yield work
        finally:
            os.chdir(old)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def phase_goldens() -> None:
    sys.path.insert(0, HERE)
    from tests.test_golden import CASE_ATOL, CASES, F64_CASES, LOGP_ATOL, parse_output
    from bioem_tpu_torch.cli import main

    runs = [(c, "Output_Probabilities.golden") for c in sorted(CASES)]
    runs += [(c, "Output_Probabilities.f64.golden") for c in F64_CASES]
    for case, golden in runs:
        model_file, maps_file, extra, _has_ang, n_ang, centers_exact = CASES[case]
        f64 = "f64" in golden
        atol = 2e-3 if f64 else CASE_ATOL.get(case, LOGP_ATOL)
        with _in_case(case, {}):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = main(["--Modelfile", model_file, "--Particlesfile", maps_file,
                           "--Inputfile", "param.txt", "--OutputFile", "out", *extra])
            require(rc == 0, f"golden {case}: CLI returned {rc}")
            lp_t, _, par_t = parse_output(open("out").read())
            lp_g, _, par_g = parse_output(open(golden).read())
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


def check_against_plain(name, res, res_p, planted, orients) -> None:
    """Argmax tuples equal to the plain branch's on every image, finite
    logP, and the planted orientation recovered on ≥ 90 % of the images."""
    import torch

    from bioem_tpu_torch.core.orientations import rotation_matrices

    require(bool(np.isfinite(res.log_prob).all()), f"{name}: non-finite logP")
    fields = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")
    same = np.all([getattr(res, f) == getattr(res_p, f) for f in fields], axis=0)
    dlp = float(np.max(np.abs(res.log_prob - res_p.log_prob)))

    # q and −q are the same rotation and both lie on the quaternion grid, so
    # recovery compares rotation matrices, not grid indices.
    def rot(idx):
        return rotation_matrices(torch.as_tensor(orients.angles[idx]), orients.use_quaternions)

    same_rot = (rot(res.best_orient) - rot(planted["orient"])).abs().amax(dim=(1, 2)) < 1e-5
    rec = float(same_rot.float().mean())
    rec_c = float(np.mean(res.best_conv == planted["ctf"]))
    say(f"[production] {name}: argmax tuples equal to the plain branch on "
        f"{int(same.sum())}/{len(same)} images; max |ΔlogP| vs plain {dlp:.3e}; planted "
        f"orientation recovered {rec:.3f}, planted CTF {rec_c:.3f}")
    require(bool(same.all()), f"{name}: argmax tuples differ from the plain branch")
    require(rec >= 0.9, f"{name}: planted orientations not recovered")


def _run(name, problem, cfg):
    """run_bioem on the card with the launches of K1, K2 and K4 it made."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, _ = problem
    fns = (cc_mod.fused_compare_block, pj.fourier_project_block,
           cc_mod.fused_compare_block_batched)
    before = [fn.launches for fn in fns]
    res, perf = run_bioem(p, orients, model, images, cfg, device=DEVICE)
    n = [fn.launches - b for fn, b in zip(fns, before)]
    say(f"[production] {name}: {perf['run_s']:.3f} s, "
        f"{perf['comparisons_per_s']:.4e} comparisons/s ({perf['comparisons']} "
        f"comparisons; K1 launches {n[0]}, K2 launches {n[1]}, K4 launches {n[2]}; "
        f"config {perf['config']}; autotuning {perf['autotune_s']:.3f} s before it)")
    return res, perf, n


def phase_production(problem):
    """The plain branch and the default kernel branch (K1); returns both
    results."""
    from bioem_tpu_torch.config import RunConfig

    planted, orients = problem[4], problem[1]
    res_p, _, _ = _run("plain branch", problem, RunConfig(use_kernels=False, autotune=False))
    require(bool(np.isfinite(res_p.log_prob).all()), "non-finite logP on the plain branch")
    res_k, _, n = _run("kernel branch (K1)", problem, RunConfig(use_kernels=True, autotune=False))
    require(n[0] > 0 and n[1] > 0, "the kernel branch did not launch K1 and K2")
    check_against_plain("kernel branch (K1)", res_k, res_p, planted, orients)
    phase_profile(problem)
    return res_p, res_k


def _profile_blocks(step, n_blocks: int) -> dict:
    """``step()`` ``n_blocks`` times, timed without and then with
    torch.profiler: wall time per block of each, the card's busy time per
    block under the profiler (the sum of its kernels' times: one stream,
    so they do not overlap), K1's and K2's time per block, and the kernels
    launched per block."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_blocks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            step()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3 / n_blocks
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "device_time_total", None) or e.cuda_time_total  # noqa: E731
    busy = sum(dev_us(e) for e in kern) * 1e-3 / n_blocks
    by = lambda key: sum(dev_us(e) for e in kern if key in e.key) * 1e-3 / n_blocks  # noqa: E731
    count = lambda key: sum(e.count for e in kern if key in e.key) / n_blocks  # noqa: E731
    # K1's launch is two kernels: its prologue (compare_fused_prep_kernel)
    # and compare_fused_kernel
    out = dict(wall_ms=wall, wall_prof_ms=wall_prof, busy_ms=busy, share=busy / wall_prof,
               k1_ms=by("compare_fused_"), k2_ms=by("project_kernel"), launches=count(""))
    out["other_ms"] = busy - out["k1_ms"] - out["k2_ms"]
    out["other_launches"] = out["launches"] - count("compare_fused_") - count("project_kernel")
    return out


def phase_profile(problem, n_blocks: int = 32, warm: int = 4) -> dict:
    """The default kernel pass (K1, o_block 8), ``n_blocks`` blocks timed
    and ``n_blocks`` more profiled after ``warm``, two ways: as the eager
    loop of block steps (a host dispatch per kernel) and as the pass runs
    it, one replay of the captured block step per block. For each: wall
    time per block without and under torch.profiler, the card's busy time
    per block and its share of the profiled wall time, K1's and K2's time
    per block, and the kernels launched per block. Where the profiler
    attributes no kernel time to the graph's replays, the replayed loop's
    wall time stands against the eager profile's busy time, and the line
    says so."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    p, orients, model, images, _ = problem
    eng = BioEMEngine(p, orients, model, images, RunConfig(use_kernels=True, autotune=False),
                      device=DEVICE)
    state = eng.initial_state()
    blk = iter(range(warm + 2 * n_blocks))  # warm-up, then timed and profiled runs

    def eager():
        b = next(blk)
        eng._block_step(state, eng.banks, eng.ang_blocks[b], b * eng.o_block,
                        eng.mask_blocks[b])

    for _ in range(warm):
        eager()
    out = {"eager": _profile_blocks(eager, n_blocks)}
    eng._graph_load(eng.initial_state(), 0)
    for _ in range(warm):
        eng._replay()
    out["replayed"] = _profile_blocks(eng._replay, n_blocks)
    for name, r in out.items():
        say(f"[profile] default kernel pass (K1, o_block {eng.o_block}), {n_blocks} blocks, "
            f"{name}: wall {r['wall_ms']:.3f} ms per block ({r['wall_prof_ms']:.3f} under "
            f"torch.profiler), card busy {r['busy_ms']:.3f} ms per block "
            f"({100 * r['share']:.1f} %), K1 (prologue and main kernel) {r['k1_ms']:.3f} ms, "
            f"K2 {r['k2_ms']:.3f} ms, the other {r['other_launches']:.1f} kernels "
            f"{r['other_ms']:.3f} ms; {r['launches']:.1f} kernels per block")
    e, g = out["eager"], out["replayed"]
    require(e["k1_ms"] > 0 and e["k2_ms"] > 0, "the profiled eager loop shows no K1 or K2 time")
    if g["busy_ms"] == 0:
        say(f"[profile] torch.profiler attributes no kernel time to the graph's replays: the "
            f"replayed wall time {g['wall_ms']:.3f} ms per block stands against the eager "
            f"loop's busy time {e['busy_ms']:.3f} ms ({100 * e['busy_ms'] / g['wall_ms']:.1f} %)")
    say(f"[profile] replayed against eager: wall {g['wall_ms']:.3f} against {e['wall_ms']:.3f} "
        f"ms per block ({e['wall_ms'] / g['wall_ms']:.2f}x)")
    return out


def phase_tuned(problem, res_p, res_k, k4_tile: int) -> None:
    """K4 forced, the autotuned run, and a checkpoint round trip."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.runtime.checkpoint import save_checkpoint

    p, orients, model, images, planted = problem
    # K4 as BIOEM_TPU_FUSED_BATCHED=1 forces it, at the default tile
    res_4, perf_4, n = _run("K4 forced", problem, RunConfig(
        use_kernels=True, autotune=False, fused_batched=True, forced=frozenset({"fused_batched"})))
    require(n[2] > 0 and perf_4["config"]["fused_batched"]
            and perf_4["config"]["kernel_img_tile"] == k4_tile,
            f"the forced pass did not launch K4 at tile {k4_tile}")
    check_against_plain("K4 forced", res_4, res_p, planted, orients)
    # The autotuner three times from an empty cache: each candidate timed
    # on its replayed loop; the winner and its pass time each time.
    tuned = []
    for k in range(3):
        cache = os.environ["BIOEM_TPU_AUTOTUNE_CACHE"]
        if os.path.exists(cache):
            os.remove(cache)
        res_a, perf_a, _ = _run(f"autotuned {k + 1} of 3 (empty cache)", problem,
                                RunConfig(autotune=True, debug_output=1))
        check_against_plain(f"autotuned {k + 1} of 3", res_a, res_p, planted, orients)
        c = perf_a["config"]
        tuned.append((("hybrid" if not c["fused_lse"] else "K4" if c["fused_batched"] else "K1"),
                      c["orient_block"], perf_a["run_s"], perf_a["autotune_s"]))
    say("[production] autotune winners from an empty cache: " + "; ".join(
        f"{w} at o_block {ob} (pass {run_s:.3f} s after {tune_s:.3f} s of tuning)"
        for w, ob, run_s, tune_s in tuned)
        + f"; the same winner all three times: {len({t[:2] for t in tuned}) == 1}")
    # the same shape again: the winner comes from the cache, untimed
    res_a, _, _ = _run("autotuned, cached", problem, RunConfig(autotune=True, debug_output=1))
    check_against_plain("autotuned, cached", res_a, res_p, planted, orients)

    # Checkpoint round trip on the kernel branch (K1): stop after half the
    # blocks, resume in a fresh engine, hold it to the straight run.
    with tempfile.TemporaryDirectory() as tmp:
        cfg = RunConfig(use_kernels=True, autotune=False,
                        checkpoint_path=os.path.join(tmp, "state.npz"))
        eng = BioEMEngine(p, orients, model, images, cfg, device=DEVICE)
        nblk = eng.ang_blocks.shape[0]
        k = nblk // 2
        state = eng.initial_state()
        for b in range(k):
            state = eng._block_step(state, eng.banks, eng.ang_blocks[b], b * eng.o_block,
                                    eng.mask_blocks[b])
        save_checkpoint(cfg.checkpoint_path, state, k, eng._fingerprint)
        del eng, state
        eng = BioEMEngine(p, orients, model, images, cfg, device=DEVICE)
        res_c = eng.results(eng.run())
    rel = float(np.max(np.abs(res_c.log_prob - res_k.log_prob) / np.abs(res_k.log_prob)))
    fields = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")
    same = all(np.array_equal(getattr(res_c, f), getattr(res_k, f)) for f in fields)
    say(f"[production] checkpoint round trip: stopped after block {k}/{nblk}, resumed in a "
        f"fresh engine; max rel |ΔlogP| vs the straight run {rel:.3e}, argmax tuples "
        f"{'equal' if same else 'DIFFER'}")
    require(rel <= 1e-12 and same, "the resumed run differs from the straight run")


def phase_probes() -> dict:
    """P1–P3 through the probe tool's functions, each held to its check;
    returns their kernel rows."""
    from bioem_tpu_torch.tools import kernel_probe as kp

    log = lambda msg: say(f"[probes] {msg}")  # noqa: E731
    p1 = kp.probe_f32_accuracy(say=log)
    for scheme in ("fma", "3xtf32"):
        require(p1["err"][scheme][0] < 1e-6,
                f"P1 {scheme}: median relative error {p1['err'][scheme][0]:.2e} ≥ 1e-6")
    require(p1["err"]["f64tc"][0] <= p1["err"]["fma"][0],
            "P1: the FP64 tensor cores are less accurate than FP32 FMA")
    require(p1["err"]["tf32"][0] > 1e-5, "P1: 1xTF32 looks f32-accurate; the probe is wrong")
    for shape, errs in p1["plain_err"].items():
        for scheme in ("fma", "3xtf32", "f64tc"):
            require(errs[scheme][0] < 1e-6 and p1["copies_equal"][shape][scheme],
                    f"P1 {scheme} at {p1['shapes'][shape]}: median relative error "
                    f"{errs[scheme][0]:.2e} from the plain version (limit 1e-6), batch copies "
                    f"{'equal' if p1['copies_equal'][shape][scheme] else 'DIFFER'}")
    p2 = kp.probe_issue_overhead(say=log)
    for st in ("loop", "batched"):
        require(p2["err"][st] <= p2["tol"][st], f"P2 {st}: beyond its f32 summation tolerance")
    p3 = kp.probe_body_ablation(say=log)
    require(all(p3["bit_equal"].values()),
            f"P3: the full variant differs from the production kernel: {p3['bit_equal']}")

    sm, sk, sn, batch = p1["shapes"]["k4_stage1"]
    b1 = bound({"tf32": 3 * 2 * sm * sk * sn * batch}, 4 * (sm * sk + sk * sn + batch * sm * sn))
    m, k, n, n_img, reps = p2["shape"]
    b2 = bound({"bf16": 2 * m * k * n * n_img * reps}, 2 * (m * k + n_img * k * n) + 4 * m * n)
    b3 = compare_bound(*p3["dims"], tensor_cores=True)
    src = "bioem_tpu_torch/csrc/"
    return {
        "P1": dict(name="f32_product (3xTF32, at K4's stage-1 shape)", route="cuda",
                   source=src + "probe.cu", replaces="tools/kernel_probe.py:34",
                   max_abs_err=p1["plain_err"]["k4_stage1"]["3xtf32"][1],
                   ms=p1["ms"]["k4_stage1"]["3xtf32"], plain_ms=p1["plain_ms"]["k4_stage1"],
                   bound_ms=b1[0], bound_by=b1[1], library_ms=p1["library_ms"]["k4_stage1"]),
        "P2": dict(name="product_sum (batched)", route="cuda", source=src + "probe.cu",
                   replaces="tools/kernel_probe.py:68", max_abs_err=p2["err"]["batched"],
                   ms=p2["ms"]["batched"], plain_ms=p2["plain_ms"], bound_ms=b2[0],
                   bound_by=b2[1], library_ms=p2["library_ms"]),
        "P3": dict(name="body_ablation (K4 full, tile 8)", route="cuda",
                   source=src + "compare_batched.cu", replaces="tools/kernel_probe.py:152",
                   max_abs_err=p3["max_abs_err"], ms=p3["ms"][("k4", "full")],
                   plain_ms=p3["plain_ms"], bound_ms=b3[0], bound_by=b3[1], library_ms=None),
    }


def phase_bestmap() -> None:
    """--PrintBestCalMap on case M against the reference binary's BESTMAP
    (tests/test_golden.py:206-240: token structure identical, floats within
    2.5e-3 abs + 2.5e-3 rel)."""
    from tests.test_torch_golden import BESTMAP_TOL, bestmap_error
    from bioem_tpu_torch.cli import main

    with _in_case("case_m_bestmap", {}):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["--Modelfile", "model.txt", "--PrintBestCalMap", "best.txt"])
        require(rc == 0, f"--PrintBestCalMap returned {rc}")
        worst, n_float = bestmap_error(open("BESTMAP").read(), open("BESTMAP.golden").read())
    say(f"[bestmap] case_m_bestmap: {n_float} values, max |Δ|/(1+|golden|) {worst:.2e} "
        f"(limit {BESTMAP_TOL})")
    require(worst <= BESTMAP_TOL and n_float >= 2 * 16 * 16, "BESTMAP values out of tolerance")


def phase_debug_prob(image: int = 1, atol: float = 1e-3) -> None:
    """Case L (N=64) through the port's CLI on the card twice, dumping
    ``image`` on the plain branch and through K3; the dumps diffed with
    the port's entry point at ``atol`` log-units, and each dump's
    log-sum-exp plus the log normalisation constant held to the image's
    LogProb within 1e-6·|logP| + 5e-5 (tests/test_debug_prob.py:39-59's
    rule plus the output's 4-decimal print)."""
    from tests.test_golden import CASES, parse_output
    from bioem_tpu_torch import debug_prob
    from bioem_tpu_torch.cli import main
    from bioem_tpu_torch.core.orientations import build_orientations
    from bioem_tpu_torch.ops.compare_cuda import fused_displacement_cc
    from bioem_tpu_torch.params import (
        log_normalization_constant, make_ctf_grid, orientation_volume_quirked, read_parameters,
    )

    case = "case_l_n64"
    model_file, maps_file, extra, *_ = CASES[case]
    dumps, k3 = {}, {}
    with tempfile.TemporaryDirectory() as keep:
        for kernel in ("plain", "kernel"):
            path = os.path.join(keep, f"dump_{kernel}.txt")
            env = {"BIOEM_TPU_DEBUG_PROB": str(image), "BIOEM_TPU_DEBUG_PROB_FILE": path,
                   "BIOEM_TPU_DEBUG_PROB_KERNEL": kernel}
            # The dump hook is wrapped to see the engine that ran: the kernel
            # dump launches K3 once per block of its orientations.
            with _in_case(case, env), mock.patch.object(
                    debug_prob, "maybe_dump_from_env",
                    wraps=debug_prob.maybe_dump_from_env) as hook:
                before = fused_displacement_cc.launches
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = main(["--Modelfile", model_file, "--Particlesfile", maps_file,
                               "--Inputfile", "param.txt", "--OutputFile", "out", *extra])
                k3[kernel] = fused_displacement_cc.launches - before
                n_blocks = hook.call_args.args[0].ang_blocks.shape[0]
                require(rc == 0, f"DEBUG_PROB {kernel}: CLI returned {rc}")
                logp = parse_output(open("out").read())[0][image]
                p = read_parameters("param.txt", not_uniform_angles=True)
                orients = build_orientations(p, extra[extra.index("--ReadOrientation") + 1])
            k_norm = log_normalization_constant(
                p, orientation_volume_quirked(p, orients.voluang, make_ctf_grid(p)))
            dumps[kernel] = path
            lp = np.array([v[1] for v in debug_prob.read_dump(path).values()])
            mx = lp.max()
            lse = float(mx + np.log(np.exp(lp - mx).sum())) + k_norm
            tol = 1e-6 * abs(logp) + 5e-5
            say(f"[debug_prob] {kernel} dump of image {image}: {lp.size} evaluations, K3 launches "
                f"in the run {k3[kernel]}; log-sum-exp + log norm. const {lse:.5f} vs LogProb "
                f"{logp:.4f} (|Δ| {abs(lse - logp):.2e}, tol {tol:.2e})")
            require(lp.size > 0 and abs(lse - logp) <= tol,
                    f"DEBUG_PROB {kernel}: the dump's log-sum-exp is not the image's logP")
        require(k3["kernel"] - k3["plain"] == n_blocks,
                f"the kernel dump launched K3 {k3['kernel'] - k3['plain']} times, "
                f"expected one per orientation block ({n_blocks})")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = debug_prob.main([dumps["plain"], dumps["kernel"], "--atol", str(atol)])
        say("[debug_prob] diff plain vs kernel: " + "; ".join(out.getvalue().splitlines()))
        require(rc == 0, f"the plain and kernel dumps differ beyond atol {atol}")


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
    # The autotuner's cache goes to a temporary file, never the working
    # directory's .bioem_tpu_autotune.json.
    cache_dir = tempfile.mkdtemp(prefix="bioem_autotune_")
    os.environ["BIOEM_TPU_AUTOTUNE_CACHE"] = os.path.join(cache_dir, "autotune.json")
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
        eng = BioEMEngine(p, orients, model, images, RunConfig(), device=DEVICE)
        require(eng.fspec is not None and eng._f32_corr_ok,
                "production problem must take the Fourier projection and the fused comparison")
        say(f"[setup] production problem: {orients.n} orientations × {eng.n_ctf} CTFs × "
            f"{eng.n_img} images, {model.n_points} points in {eng.fspec.n_groups} radius "
            f"groups, set up in {time.perf_counter() - t0:.1f} s")
        rows = phase_kernels(torch, eng)
        del eng

        counters = {"K1": cc_mod.fused_compare_block, "K2": pj.fourier_project_block,
                    "K3": cc_mod.fused_displacement_cc,
                    "K4": cc_mod.fused_compare_block_batched}

        def main_path(name, drive, kernels):
            """Counts from 0 around one path; each of ``kernels`` must launch."""
            for fn in counters.values():
                fn.launches = 0
            out = drive()
            say(f"[main path] {name} launches: "
                + ", ".join(f"{k} {fn.launches}" for k, fn in counters.items()))
            require(all(counters[k].launches > 0 for k in kernels),
                    f"a kernel of {name} ({', '.join(kernels)}) was never launched")
            for k, fn in counters.items():
                if k in rows:
                    rows[k]["launches"] = rows[k].get("launches", 0) + fn.launches
            return out

        def goldens_and_k1():
            phase_goldens()
            return phase_production(problem)

        res_p, res_k = main_path("goldens + production K1", goldens_and_k1, ("K1", "K2", "K3"))
        main_path("production K4 + autotuned + checkpoint",
                  lambda: phase_tuned(problem, res_p, res_k, rows["K4"]["tile"]), ("K2", "K4"))
        from bioem_tpu_torch.ops import probe_cuda

        counters.update(P1=probe_cuda.f32_product, P2=probe_cuda.product_sum,
                        P3=probe_cuda.body_ablation)
        probe_rows = main_path("probe tool", phase_probes, ("P1", "P2", "P3"))
        for k, r in probe_rows.items():
            rows[k] = {**r, "launches": counters[k].launches}
        phase_bestmap()
        main_path("DEBUG_PROB", phase_debug_prob, ("K3",))
    except Exception as e:  # every phase failure ends the run with a nonzero code
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    say(f"[done] chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    say(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
