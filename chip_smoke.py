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
6. streaming: the 64 production images through run_streaming in chunks of
   16 on K1, one capture for all chunks, equal to the K1 run_bioem of
   step 5; a checkpointed streamed run that dies reading chunk 2, resumed,
   equal to the straight streamed run;
7. ranking: rank_models with the production model against it jittered by
   2 Å and with 50 points removed (other per-group point counts, which
   K2 reads per model), one capture for the three, each candidate equal
   to its own run_bioem, the production model first;
8. refinement: refine_results after the tuned pass on as many production
   images as fit its time budget (the cut printed), every refined logpro
   at or above its seed; 8 images planted off-grid with the smooth
   forward model at N = 224, the refined rotation and displacement closer
   to the truth than the grid seed on ≥ 7; 2 of them refined on the card
   and on the CPU, held to the CPU parity test's tolerances; --Refine
   through the port's CLI on golden case A;
9. the kernel probe tool (bioem_tpu_torch.tools.kernel_probe): P1 (the
   f32 product's accuracy by scheme, and each scheme's card time at K4's
   stage-1 shape beside its bound and torch.matmul f32's), P2 (looped vs
   batched products on wgmma across the card, beside one cuBLAS GEMM
   doing all of them) and P3 (the K1/K4 body ablation at the production block),
   each held to its check;
10. --PrintBestCalMap on golden case M through the port's CLI, held to
   tests/test_golden.py's BESTMAP rule;
11. DEBUG_PROB: golden case L (N=64) through the port's CLI twice, dumping
   one image on the plain branch and through K3, diffed with the port's
   diff entry point, and the dump's log-sum-exp held to the image's logP;
12. the (images × orientations) mesh (after ranking): the production
   problem on a 2×2 mesh of four slots on the one card (K1, each slot its
   own captured graph), held to the single engine's K1 pass at |ΔlogP| ≤
   1e-10·max|logP| (and the per-angle logP), argmax tuples equal, four
   captures, twice (the second pass replays only), each pass's wait for
   the card, merge and garbage-collector pauses printed; then 2×2, 1×4
   and 4×1 at 1088 orientations, held the same way;
13. multi-process: two processes of this script (``--mp-worker``) on the
   card over gloo, two slots each of a global 2×2 mesh at 1088
   orientations: the pass bit-equal to the one-process 2×2 run; a run
   streamed in 2 chunks in which each process reads only its rows; a
   checkpointed run stopped mid-slot and resumed;
14. the native C++ ingest: a 2048-image 224² MRC stack (~411 MB) and a
   500-point text model read natively and with NumPy, bit-equal, both
   times printed;
15. accuracy: tools/accuracy_probe (the CLI and golden_error_budget) on
   golden cases L (N = 64) and N (N = 224) under the plain branch, K1, K4
   forced and the hybrid, on the cases' maps and normalised (where K1 and
   K4 pass the f32 gate): each engine within oracle–golden / 50 of the
   all-f64 oracle, the plain branch also within the JAX suite's 2e-5 and
   5e-6;
16. examples: planted recovery and the tutorial (its CLI and ranking in
   processes of their own), both passing;
17. tools/profile_block and tools/trace_step on 8 replayed production
   blocks: every kernel at ≥ 1 % by name (K1 and K2 among them), the rest
   as ``other``, within 5 % of the profiler's device time, and the glue
   grouped by the block step's phase and the torch op that launched it;
18. tools/scale_bench at 4608 and 36864 orientations, per-angle slabs off
   and on: comparisons/s, peak card memory, finite logP;
19. tools/stream_50k cut to 2048 images in 2 chunks of 1024 at 4608
   orientations: one capture, finite logP, peak card memory;
20. at 1088 orientations: tools/rank_bench (3 models, reuse faster than
   the naive estimate), tools/mesh_scale_bench (1 to 4 slots on the one
   card, each within 1e-6·max|logP| of one slot), tools/pipeline_lab
   (the fused and hybrid pipelines' device time per step) and
   tools/noise_recovery_table (1 trial at noise 0 and 1).

The paths are driven in parts, each with every kernel's launch counter
set to 0 just before it and read just after: the goldens with the plain
and K1 passes must launch K1, K2 and K3; the K4, autotuned and checkpoint
passes K2 and K4; streaming, ranking and the mesh K1 and K2 (the
multi-process workers report theirs); the refinement phase (its grid
passes) K2; the probe tool P1, P2 and P3; the DEBUG_PROB runs
K3; the accuracy phase K1, K3 and K4; the examples K2 and K3; the profile
tools, scale and the stream cut K1 and K2; the last tools K1, K2 and K3. Each
part's line gives its seconds.
The line before the last is a JSON object describing every kernel, with
its launches on those paths, its time beside its plain version's, the
least time the card could take for the same work (``bound_ms``, from the
shapes of this run's inputs and the H100 peaks in tools/problem.py) and, where one
PyTorch call computes the same function, that call's time; the last line
is ``{"ok": true, "device": {...}}`` and is printed only when every phase
passed. Exits non-zero without a result when no CUDA device is present or
when the port's package is not next to this script.
"""

from __future__ import annotations

import contextlib
import copy
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

def p1_bounds(m, k, n, batch) -> dict:
    """{scheme: (ms, by)} of P1's ``batch`` products (M, K)·(K, N): 2·M·K·N
    per product in f32 on the CUDA cores (FMA), three TF32 products
    (3xTF32), one (1xTF32), or on the FP64 tensor cores; A and B read once,
    every copy of C written."""
    from bioem_tpu_torch.tools.problem import bound

    flops = 2 * m * k * n * batch
    nbytes = 4 * (m * k + k * n + batch * m * n)
    return {"fma": bound({"f32": flops}, nbytes), "3xtf32": bound({"tf32": 3 * flops}, nbytes),
            "tf32": bound({"tf32": flops}, nbytes), "f64tc": bound({"f64": flops}, nbytes)}


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
    from bioem_tpu_torch.tools.problem import bound, compare_bound, compare_work
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
    from torch.profiler import ProfilerActivity, profile

    from bioem_tpu_torch.tools.trace_step import device_kernels

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
    kern = device_kernels(prof.key_averages())
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


ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")


def _held(name, res, ref, tol=1e-6) -> None:
    """Argmax tuples equal on every image and max |ΔlogP| ≤ ``tol``."""
    same = np.all([getattr(res, f) == getattr(ref, f) for f in ARGMAX], axis=0)
    dlp = float(np.max(np.abs(res.log_prob - ref.log_prob)))
    say(f"[{name}] argmax tuples equal on {int(same.sum())}/{len(same)} images, "
        f"max |ΔlogP| {dlp:.3e} (limit {tol:g})")
    require(bool(same.all()) and dlp <= tol, f"{name}: differs beyond its limit")


class _ReadFailure(Exception):
    pass


class _FailingSource:
    """An image source whose reads from ``fail_at`` on raise: a streamed run
    that dies while chunk ``fail_at // chunk`` is read."""

    def __init__(self, maps, fail_at):
        self.maps, self.fail_at = maps, fail_at

    @property
    def n_images(self):
        return self.maps.shape[0]

    def chunk(self, start, stop):
        if start >= self.fail_at:
            raise _ReadFailure(f"read of images [{start}, {stop}) failed")
        return self.maps[start:stop]


def phase_streaming(problem, res_k, card: str, chunk: int = 16) -> None:
    """The production images streamed in chunks of ``chunk`` through
    run_streaming on the kernel branch (K1): one capture for every chunk,
    equal to run_bioem over all 64 images (res_k) to 1e-6 with the argmax
    tuples exact; then a checkpointed streamed run that dies reading
    chunk 2, resumed, equal to the straight streamed run (its chunks 0 and
    1 loaded from their checkpoints, not recomputed)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.stream import ArraySource, run_streaming

    p, orients, model, images, _ = problem
    cfg = RunConfig(use_kernels=True, autotune=False)
    t0 = time.perf_counter()
    res, perf = run_streaming(p, orients, model, ArraySource(images.maps), cfg,
                              chunk_images=chunk, device=DEVICE)
    wall = time.perf_counter() - t0
    say(f"[streaming] {card}: {images.n} images in {perf['chunks']} chunks of {chunk}: "
        f"{wall:.3f} s ({perf['run_s'] / perf['chunks']:.3f} s per chunk, "
        f"{perf['comparisons'] / perf['run_s']:.4e} comparisons/s), captures {perf['captures']}")
    require(perf["captures"] == 1, "the streamed chunks did not share one capture")
    _held("streaming", res, res_k)
    with tempfile.TemporaryDirectory() as tmp:
        ck = RunConfig(use_kernels=True, autotune=False,
                       checkpoint_path=os.path.join(tmp, "stream.npz"))
        try:
            run_streaming(p, orients, model, _FailingSource(images.maps, 2 * chunk), ck,
                          chunk_images=chunk, device=DEVICE)
            require(False, "the failing source did not fail")
        except _ReadFailure as e:
            say(f"[streaming] checkpointed run stopped: {e}")
        done = sorted(f for f in os.listdir(tmp) if ".chunk" in f)
        before = cc_mod.fused_compare_block.launches
        t0 = time.perf_counter()
        res_r, _ = run_streaming(p, orients, model, ArraySource(images.maps), ck,
                                 chunk_images=chunk, device=DEVICE)
        k1 = cc_mod.fused_compare_block.launches - before
    say(f"[streaming] resumed with checkpoints {done}: {time.perf_counter() - t0:.3f} s, "
        f"K1 launches {k1} (the straight streamed run's chunks: {perf['chunks']})")
    require(res_r.log_prob.tobytes() == res.log_prob.tobytes()
            and all(np.array_equal(getattr(res_r, f), getattr(res, f)) for f in ARGMAX),
            "the resumed streamed run differs from the straight one")
    say("[streaming] resumed streamed run equal to the straight streamed run (logP bit-equal)")


def phase_ranking(problem, card: str) -> None:
    """rank_models on the production images: the production model against
    the same model with its points jittered by 2 Å and with 50 points
    removed (its per-group point counts differ: K2 reads them per model).
    One capture for the three; each model's per-image logP and argmax
    tuples equal an independent run_bioem of it to 1e-6; the production
    model ranks first."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.io.model_io import Model
    from bioem_tpu_torch.rank import rank_models
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, _ = problem
    rng = np.random.default_rng(SEED + 1)
    step = rng.normal(size=model.points.shape)
    step *= 2.0 / np.linalg.norm(step, axis=1, keepdims=True)
    jittered = Model((model.points + step).astype(np.float32), model.radii, model.densities,
                     model.norm_den)
    # 50 points away, at least one kept in every radius group
    keep = np.ones(model.n_points, bool)
    for i in rng.permutation(model.n_points):
        if (~keep).sum() == 50:
            break
        if (keep & (model.radii == model.radii[i])).sum() > 1:
            keep[i] = False
    dens = model.densities[keep]
    removed = Model(model.points[keep], model.radii[keep], dens, float(dens.sum()))
    models = [model, jittered, removed]
    names = ["production", "jittered 2 A", "50 points removed"]
    cfg = RunConfig(use_kernels=True, autotune=False)
    t0 = time.perf_counter()
    total, per_image, perf = rank_models(p, orients, models, images, cfg, device=DEVICE)
    wall = time.perf_counter() - t0
    say(f"[ranking] {card}: {len(models)} models × {images.n} images: {wall:.3f} s "
        f"({perf['run_s'] / len(models):.3f} s per model), captures {perf['captures']}; "
        + ", ".join(f"{n} lnP {t:.4f}" for n, t in zip(names, total)))
    require(perf["captures"] == 1, "the ranked models did not share one capture")
    require(int(np.argmax(total)) == 0, "the production model does not rank first")
    for m in (1, 2):
        own, _ = run_bioem(p, orients, models[m], images, cfg, device=DEVICE)
        _held(f"ranking: {names[m]} vs its own run_bioem", perf["results"][m], own)


# ---------------------------------------------------------------------------
# The (images × orientations) mesh, multi-process runs, the native ingest
# ---------------------------------------------------------------------------

MESH_DEPTH = 1088  # orientations of the reduced-depth mesh runs (a quarter)


def _held_rel(name, res, ref, rel=1e-10, angles=True) -> bool:
    """|ΔlogP| ≤ ``rel`` × max|logP| (and for the per-angle logP), the
    argmax tuples equal; returns whether logP is bit-equal."""
    same = np.all([getattr(res, f) == getattr(ref, f) for f in ARGMAX], axis=0)
    dlp = float(np.max(np.abs(res.log_prob - ref.log_prob)))
    lim = rel * float(np.max(np.abs(ref.log_prob)))
    ok = bool(same.all()) and dlp <= lim
    msg = (f"[{name}] argmax tuples equal on {int(same.sum())}/{len(same)} images, "
           f"max |ΔlogP| {dlp:.3e} (limit {lim:.3e})")
    if angles and ref.angle_log is not None:
        da = float(np.max(np.abs(res.angle_log - ref.angle_log)))
        lim_a = rel * float(np.max(np.abs(ref.angle_log)))
        msg += f", max |Δ angle logP| {da:.3e} (limit {lim_a:.3e})"
        ok &= da <= lim_a
    bits = res.log_prob.tobytes() == ref.log_prob.tobytes()
    say(msg + f", logP bit-equal {bits}")
    require(ok, f"{name}: differs beyond its limit")
    return bits


@contextlib.contextmanager
def _gc_pauses():
    """Yields a dict that holds, on exit, the collections of Python's
    garbage collector inside the block and their seconds."""
    import gc

    out, started = {"n": 0, "s": 0.0}, []

    def cb(phase, _info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            out["n"] += 1
            out["s"] += time.perf_counter() - started.pop()

    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def _mesh_pass(eng) -> tuple:
    """(results, seconds of run + results, the line's timing text) of one
    pass of ``eng``: the slots' queueing, the wait for the card, the merge
    and the garbage collector's pauses inside the pass."""
    import torch

    with _gc_pauses() as gcp:
        t0 = time.perf_counter()
        res = eng.results(eng.run())
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    return res, t, (f"{t:.3f} s run + results (waiting for the card {eng.wait_s * 1e3:.1f} "
                    f"ms, merge {eng.merge_s * 1e3:.2f} ms; {gcp['n']} garbage collections, "
                    f"{gcp['s'] * 1e3:.1f} ms), captures {eng.captures}")


def _mesh_run(problem, mi: int, mo: int, cfg):
    """A ShardedBioEMEngine with ``mi × mo`` slots all on cuda:0 and its
    first pass; returns (results, seconds of construction, seconds of run +
    results, the pass's timing text, engine)."""
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh

    p, orients, model, images, _ = problem
    t0 = time.perf_counter()
    eng = ShardedBioEMEngine(p, orients, model, images, cfg,
                             mesh=make_bioem_mesh(mi, mo, devices=["cuda:0"] * (mi * mo)))
    t_setup = time.perf_counter() - t0
    res, t, text = _mesh_pass(eng)
    return res, t_setup, t, text, eng


def phase_mesh(problem, res_k, card: str) -> object:
    """The production problem on a 2×2 mesh of four slots on the one card
    (K1, the default branch), with the per-angle slabs on: held to the
    single engine's K1 pass (phase_production's res_k, and a single pass
    with the slabs) at |ΔlogP| ≤ 1e-10·max|logP|, the argmax tuples equal,
    four captures; then 1×4 and 4×1 meshes at MESH_DEPTH orientations held
    the same way to a single pass at that depth. Returns the 2×2 mesh's
    results at MESH_DEPTH (the multi-process phase's reference)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, planted = problem
    pa = copy.copy(p)
    pa.write_angles = 1
    prob_a = (pa, orients, model, images, planted)
    cfg = RunConfig(use_kernels=True, autotune=False)
    single, perf_s = run_bioem(pa, orients, model, images, cfg, device=DEVICE)
    res, t_setup, t_run, text, eng = _mesh_run(prob_a, 2, 2, RunConfig(
        use_kernels=True, autotune=False, mesh_images=2, mesh_orient=2))
    say(f"[mesh] {card}: production problem on a 2×2 mesh of 4 slots on cuda:0 (K1), "
        f"{len(eng.slots)} slots of {eng.n_img_pad // 2} image rows × "
        f"{eng.n_orient_pad // 2} orientations, set-up {t_setup:.3f} s; first pass {text} "
        f"({eng.n_orient * eng.n_ctf * eng.n_img / t_run:.4e} comparisons/s; the single "
        f"engine's pass with the slabs {perf_s['run_s']:.3f} s)")
    require(eng.captures == 4, "the 2×2 mesh did not capture once per slot")
    require(not eng.fused_batched and eng.fused_lse, "the mesh left the default K1 branch")
    _held_rel("mesh 2×2 vs the single engine (slabs on)", res, single)
    _held_rel("mesh 2×2 vs phase_production's K1 pass", res, res_k, angles=False)
    res, t_run, text = _mesh_pass(eng)
    say(f"[mesh] the same engine's second pass (replays only): {text} "
        f"({eng.n_orient * eng.n_ctf * eng.n_img / t_run:.4e} comparisons/s)")
    require(eng.captures == 4, "the second pass captured again")
    _held_rel("mesh 2×2, second pass, vs the single engine (slabs on)", res, single)
    del eng
    depth = RunConfig(use_kernels=True, autotune=False, debug_break=MESH_DEPTH)
    ref, _ = run_bioem(p, orients, model, images, depth, device=DEVICE)
    out = None
    for mi, mo in ((2, 2), (1, 4), (4, 1)):
        r, t_setup, _t, text, eng = _mesh_run(problem, mi, mo, RunConfig(
            use_kernels=True, autotune=False, debug_break=MESH_DEPTH, mesh_images=mi,
            mesh_orient=mo))
        say(f"[mesh] {mi}×{mo} at {MESH_DEPTH} orientations: set-up {t_setup:.3f} s, "
            f"first pass {text}")
        require(eng.captures == mi * mo, f"the {mi}×{mo} mesh did not capture once per slot")
        _held_rel(f"mesh {mi}×{mo} at {MESH_DEPTH} vs the single engine", r, ref)
        out = r if (mi, mo) == (2, 2) else out
        del eng
    return out


RESULT_FIELDS = ("log_prob", "best_orient", "best_conv", "best_cent_x", "best_cent_y",
                 "best_norm", "best_mu")


class _Stop(Exception):
    """Raised by the worker's checkpoint hook: a run that dies mid-slot."""


def mp_worker(rank: int, port: int, out_dir: str) -> int:
    """One of two processes on cuda:0 (``chip_smoke.py --mp-worker``): two
    slots of a global 2×2 mesh at MESH_DEPTH orientations over gloo. Runs
    (1) the pass; (2) the images streamed in 2 chunks of 32 at image tile
    16, each process reading only the rows its slots own; (3) a
    checkpointed pass that dies after its second slot's first save (both
    processes, before the merge), then the same pass resumed in a fresh
    engine. The images are the parent's (``out_dir/maps.npy``), as the
    processes of a real run read the same files: on the card's host the
    seed-made images have come out different in one of two processes
    building them at once (the line says whether this process's own build
    equals the parent's). Process 0 writes each result to ``out_dir``; each
    process prints one JSON line with its reads and kernel launches."""
    import torch

    sys.path.insert(0, HERE)
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.io.map_io import ImageStack
    from bioem_tpu_torch.ops import _build
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.parallel import distributed
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh
    from bioem_tpu_torch.runtime import checkpoint
    from bioem_tpu_torch.stream import ArraySource, run_streaming
    from bioem_tpu_torch.tools.problem import build_problem

    _build.load(verbose=True)  # the library the parent built (its flags key it)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, timeout_s=240)
    p, orients, model, own, _ = build_problem()
    images = ImageStack(np.load(os.path.join(out_dir, "maps.npy")))
    own_equal = own.maps.tobytes() == images.maps.tobytes()
    mesh = make_bioem_mesh(2, 2, devices=["cuda:0"] * 2)
    base = dict(use_kernels=True, autotune=False, debug_break=MESH_DEPTH, mesh_images=2,
                mesh_orient=2)

    def save(name, res):
        if rank == 0:
            np.savez(os.path.join(out_dir, name), **{f: getattr(res, f) for f in RESULT_FIELDS})

    times = {}
    t0 = time.perf_counter()
    eng = ShardedBioEMEngine(p, orients, model, images, RunConfig(**base), mesh=mesh)
    res = eng.results(eng.run())
    times["run"] = time.perf_counter() - t0
    save("run.npz", res)
    del eng

    reads = []

    class Recording(ArraySource):
        def chunk(self, start, stop):
            reads.append((start, stop))
            return super().chunk(start, stop)

    t0 = time.perf_counter()
    res, perf = run_streaming(p, orients, model, Recording(images.maps),
                              RunConfig(**base, kernel_img_tile=16), chunk_images=32,
                              device="cuda:0", mesh=mesh)
    times["stream"] = time.perf_counter() - t0
    save("stream.npz", res)

    ck = RunConfig(**base, checkpoint_path=os.path.join(out_dir, f"ck{rank}.npz"),
                   checkpoint_every=16)
    real_save = checkpoint.save_checkpoint
    saves = []

    def dying_save(path, state, nxt, fp):
        real_save(path, state, nxt, fp)
        saves.append(path)
        if path.endswith(("slot0x1", "slot1x1")):  # this process's second slot
            raise _Stop(f"stopped after {path} block {nxt}")

    checkpoint.save_checkpoint = dying_save
    try:
        ShardedBioEMEngine(p, orients, model, images, ck, mesh=mesh).run()
        stopped = "did not stop"
    except _Stop as e:
        stopped = str(e)
    finally:
        checkpoint.save_checkpoint = real_save
    k1 = cc_mod.fused_compare_block.launches
    t0 = time.perf_counter()
    eng = ShardedBioEMEngine(p, orients, model, images, ck, mesh=mesh)
    res = eng.results(eng.run())
    times["resumed"] = time.perf_counter() - t0
    k1_resumed = cc_mod.fused_compare_block.launches - k1
    save("resumed.npz", res)
    print(json.dumps({"rank": rank, "reads": reads, "stopped": stopped, "own_images_equal": own_equal,
                      "captures_stream": perf["captures"], "times": times,
                      "k1_resumed": k1_resumed, "blocks_per_slot": eng.slots[
                          next(iter(eng.slots))].ang_blocks.shape[0],
                      "launches": {"K1": cc_mod.fused_compare_block.launches,
                                   "K2": pj.fourier_project_block.launches,
                                   "K3": cc_mod.fused_displacement_cc.launches,
                                   "K4": cc_mod.fused_compare_block_batched.launches}}),
          flush=True)
    torch.cuda.synchronize()
    distributed.shutdown()
    return 0


def phase_multiprocess(ref_2x2, maps, card: str) -> dict:
    """Two processes on the one card (``--mp-worker``), a free TCP port,
    gloo, two slots each of a global 2×2 mesh at MESH_DEPTH orientations,
    on the parent's images ``maps``:
    the pass equal to the one-process 2×2 run (``ref_2x2``, phase_mesh's)
    bit for bit; the streamed run (process 1 reading only its rows of the
    second chunk) and the checkpointed run resumed after a stop held to it
    at 1e-10 relative with the argmax tuples equal. Returns the kernel
    launches the two workers made."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        np.save(os.path.join(out_dir, "maps.npy"), maps)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                                   str(r), str(port), out_dir],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for pr in procs:
                logs.append(pr.communicate(timeout=400)[0])
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.communicate()
        wall = time.perf_counter() - t0
        for r, (pr, log) in enumerate(zip(procs, logs)):
            require(pr.returncode == 0, f"worker {r} exited {pr.returncode}:\n{log[-4000:]}")
        info = [json.loads([ln for ln in log.splitlines() if ln.startswith('{"rank"')][-1])
                for log in logs]
        got = {k: dict(np.load(os.path.join(out_dir, f"{k}.npz")))
               for k in ("run", "stream", "resumed")}
    say(f"[multiprocess] {card}: 2 processes × 2 slots on cuda:0 over gloo, {wall:.1f} s "
        f"wall; per process: " + "; ".join(
            f"rank {i['rank']} run {i['times']['run']:.3f} s, streamed {i['times']['stream']:.3f} s "
            f"(captures {i['captures_stream']}), resumed {i['times']['resumed']:.3f} s "
            f"({i['stopped']}; K1 launches {i['k1_resumed']} for {i['blocks_per_slot']} blocks "
            f"per slot; its own seed-made images equal the parent's: {i['own_images_equal']})"
            for i in info))
    for i in info:
        require(i["stopped"].startswith("stopped"), f"rank {i['rank']}: the run did not stop")
        require(i["captures_stream"] == 2, f"rank {i['rank']}: streaming captured "
                f"{i['captures_stream']} times for its 2 slots")
        # the resumed pass replays only what the stopped one did not finish
        require(i["k1_resumed"] < 2 * i["blocks_per_slot"],
                f"rank {i['rank']}: the resumed pass recomputed everything")
    later = [sorted((a, b) for a, b in i["reads"] if a >= 32) for i in info]
    say(f"[multiprocess] second chunk's reads: rank 0 {later[0]}, rank 1 {later[1]}")
    require(later[0] == [(32, 48)] and later[1] == [(48, 64)],
            "a process read rows of the second chunk that its slots do not own")

    from types import SimpleNamespace

    for k in ("run", "stream", "resumed"):
        bits = _held_rel(f"multiprocess {k} vs the one-process 2×2 run",
                         SimpleNamespace(**got[k], angle_log=None), ref_2x2)
        if k == "run":
            same = all(np.array_equal(got[k][f], getattr(ref_2x2, f)) for f in RESULT_FIELDS)
            say(f"[multiprocess] run: every field bit-equal to the one-process run: {same}")
            require(bits and same, "the two-process run is not bit-equal to the one-process run")
    out = {k: sum(i["launches"][k] for i in info) for k in ("K1", "K2", "K3", "K4")}
    say("[multiprocess] the workers' launches: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    require(out["K1"] > 0 and out["K2"] > 0, "the workers did not launch K1 and K2")
    return out


def phase_native(card: str, n_img: int = 2048, n_pix: int = 224) -> None:
    """The native C++ ingest against the NumPy readers on a production-size
    stack (``n_img`` images of 224², f32 MRC, ~411 MB) and a 500-point text
    model, written under a temporary directory: bit-equal, the native
    reader run (its call counter), both times printed (host seconds)."""
    from bioem_tpu_torch.io.map_io import read_mrc_maps
    from bioem_tpu_torch.io.model_io import read_text_model
    from bioem_tpu_torch.io.mrc import write_mrc
    from bioem_tpu_torch.runtime import native

    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    lib = native.get_lib()
    t_build = time.perf_counter() - t0
    require(lib is not None, "the native ingest did not build")
    with tempfile.TemporaryDirectory() as tmp:
        stack = rng.normal(0.1, 1.3, (n_img, n_pix, n_pix)).astype(np.float32)
        mrc = os.path.join(tmp, "stack.mrc")
        write_mrc(mrc, stack)
        del stack
        model = os.path.join(tmp, "model.txt")
        with open(model, "w") as f:
            for row in np.column_stack([rng.uniform(-80, 80, (500, 3)), rng.uniform(1, 4, 500),
                                        rng.uniform(20, 120, 500)]):
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        gb = os.path.getsize(mrc) / 1e9
        saved = os.environ.get("BIOEM_TPU_NATIVE_IO")
        times = {}
        try:
            def model_rows():
                m = read_text_model(model)
                return np.concatenate([m.points.ravel(), m.radii, m.densities])

            for what, path, read in (("MRC stack", mrc, lambda: read_mrc_maps(mrc, n_pix).maps),
                                     ("text model", model, model_rows)):
                key = "mrc_stack" if what == "MRC stack" else "text_model"
                os.environ["BIOEM_TPU_NATIVE_IO"] = "1"
                before = native.calls[key]
                t0 = time.perf_counter()
                fast = read()
                t_fast = time.perf_counter() - t0
                require(native.calls[key] == before + 1, f"{what}: the native reader did not run")
                os.environ["BIOEM_TPU_NATIVE_IO"] = "0"
                t0 = time.perf_counter()
                slow = read()
                t_slow = time.perf_counter() - t0
                require(native.calls[key] == before + 1, f"{what}: NumPy read went native")
                equal = fast.tobytes() == slow.tobytes()
                times[what] = (t_fast, t_slow)
                say(f"[native] {what} ({os.path.getsize(path) / 1e6:.1f} MB): native "
                    f"{t_fast:.3f} s, NumPy {t_slow:.3f} s, bit-equal {equal}")
                require(equal, f"{what}: the native and NumPy readers differ")
                del fast, slow
        finally:
            if saved is None:
                os.environ.pop("BIOEM_TPU_NATIVE_IO", None)
            else:
                os.environ["BIOEM_TPU_NATIVE_IO"] = saved
    t_fast, t_slow = times["MRC stack"]
    say(f"[native] {card}: library load/build {t_build:.2f} s; MRC ingest "
        f"{gb / t_fast:.2f} GB/s native, {gb / t_slow:.2f} GB/s NumPy "
        f"({n_img} images of {n_pix}², normalised, host {os.cpu_count()} cores)")


def _angle(a, b) -> float:
    tr = np.trace(np.asarray(a, np.float64) @ np.asarray(b, np.float64).T)
    return float(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def _planted_offgrid(eng, n_img: int, rng, noise: float = 0.5):
    """``n_img`` images of the port's smooth forward model (refine.py) at
    N = 224: per image a grid orientation turned by half the grid's
    nearest-neighbour step about a random axis, a grid CTF, and a sub-pixel
    displacement; noise at ``noise`` times the signal's spread. Returns the
    maps, the planted rotations and displacements, the half step and the
    grid orientation each plant was turned from."""
    import torch

    from bioem_tpu_torch.core.orientations import rotation_matrices
    from bioem_tpu_torch.core.projection import fourier_epilogue
    from bioem_tpu_torch.io.map_io import _normalize_stack
    from bioem_tpu_torch.refine import exp_so3, smooth_ctf_spectrum, smooth_projection_phases

    p, b = eng.p, eng.banks
    n = p.n_pixels
    rots = rotation_matrices(torch.as_tensor(eng.orients.angles), True).double().numpy()
    o_idx = rng.integers(0, eng.n_orient, n_img)
    # the grid's nearest-neighbour step at the first planted orientation,
    # from the quaternions in f64 (the grid holds each rotation twice, as q
    # and −q: the angle 2·acos|q·q'| skips those)
    q = eng.orients.angles.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ang = 2.0 * np.arccos(np.clip(np.abs(q @ q[o_idx[0]]), 0.0, 1.0))
    half = 0.5 * float(ang[ang > 1e-3].min())
    maps, rot_star, d_star = [], [], []
    k1 = ((np.arange(n) + n // 2) % n - n // 2)[:, None]
    k2 = np.arange(n // 2 + 1)[None, :]
    for o in o_idx:
        axis = rng.normal(size=3)
        w = half * axis / np.linalg.norm(axis)
        r = exp_so3(torch.as_tensor(w)).numpy() @ rots[o]
        c = int(rng.integers(0, eng.n_ctf))
        d = rng.uniform(-3.0, 3.0, 2)
        th_x, th_y = smooth_projection_phases(n, p.pixel_size, p.shift_x, p.shift_y,
                                              torch.as_tensor(r, dtype=torch.float32,
                                                              device=b.points.device),
                                              b.points, b.radii)
        pr, pi = fourier_epilogue(eng.fspec, th_x, th_y, b.dens, b.norm_den, b.st_re, b.st_im,
                                  b.st_sums, signed_rows=True)
        ctf = smooth_ctf_spectrum(n, p.pixel_size, p.use_psf, b.amp[c], b.pha[c], b.env[c])
        spec = ((pr + 1j * pi) * ctf).cpu().numpy().astype(np.complex128)
        spec = spec * np.exp(-2j * np.pi * (k1 * d[0] + k2 * d[1]) / n)
        img = np.fft.irfft2(spec, s=(n, n))
        img = img + rng.normal(0.0, noise * img.std(), img.shape)
        maps.append(img)
        rot_star.append(r)
        d_star.append(d)
    return (_normalize_stack(np.stack(maps).astype(np.float32)), np.stack(rot_star),
            np.stack(d_star), half, o_idx)


def _parse_refined(text: str) -> np.ndarray:
    rows = []
    for line in text.splitlines():
        if line.startswith("RefMap:"):
            tok = line.replace("->", " ").split()
            rows.append([float(x) for x in tok if x[0].isdigit() or x[0] in "-."
                         or x.lower() in ("nan", "inf", "-inf")])
    return np.array(rows)


def phase_refinement(problem, card: str, budget_s: float = 15.0) -> dict:
    """Continuous refinement on the card:
    1. refine_results after the tuned pass (the autotuner's cached winner),
       on as many of the 64 production images as fit ``budget_s`` at the
       rate of a first batch (the cut is printed): every logpro_refined ≥
       its seed, every grad_norm finite;
    2. 8 images planted off-grid with the smooth forward model (half a grid
       step in rotation, a sub-pixel displacement): the refined rotation
       and displacement closer to the truth than the grid seed on ≥ 7;
    3. 2 of them (seeded at the orientation their plant was turned from)
       refined from the seed to convergence on the card and by the port on
       the CPU, held to the CPU parity test's tolerances
       (tests/test_torch_refine.py);
    4. --Refine through the port's CLI on golden case A: a finite
       Output_Refined row per image."""
    import torch

    from bioem_tpu_torch.cli import main as cli_main
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.core.orientations import rotation_matrices
    from bioem_tpu_torch.io.map_io import ImageStack
    from bioem_tpu_torch.refine import refine_results
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, _ = problem
    out = {}
    res_a, perf_a = run_bioem(p, orients, model, images, RunConfig(autotune=True), device=DEVICE)
    eng = perf_a["engine"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = 8
    t0 = time.perf_counter()
    r1 = refine_results(eng, res_a, image_indices=np.arange(first))
    t_first = time.perf_counter() - t0
    per_img = t_first / first
    n_more = int(min(images.n - first, max(0.0, budget_s - t_first) // per_img))
    rs = [r1]
    if n_more:
        rs.append(refine_results(eng, res_a, image_indices=np.arange(first, first + n_more)))
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    n_ref = first + n_more
    lp0 = np.concatenate([r.logpro_seed for r in rs])
    lp1 = np.concatenate([r.logpro_refined for r in rs])
    gn = np.concatenate([r.grad_norm for r in rs])
    say(f"[refinement] {card}: production images after the tuned pass "
        f"({'K4' if eng.fused_batched else 'K1'}, o_block {eng.o_block}): {n_ref} of {images.n} "
        f"refined (cut to fit {budget_s:.0f} s at the first {first} images' rate), "
        f"{t_all:.3f} s, {t_all / n_ref:.3f} s per image, image chunk {r1.image_chunk}, "
        f"16 starts × 60 iterations, peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; logpro gain median "
        f"{float(np.median(lp1 - lp0)):.3f}, min {float(np.min(lp1 - lp0)):.3e}; "
        f"grad_norm max {float(np.max(gn)):.3e}")
    require(bool(np.all(lp1 >= lp0)), "a refined logpro fell below its seed")
    require(bool(np.all(np.isfinite(gn)) and np.all(np.isfinite(lp1))),
            "non-finite refinement result")
    out.update(n_ref=n_ref, s_per_image=t_all / n_ref, chunk=r1.image_chunk)
    del eng, perf_a, rs, r1

    # off-grid planted images at N = 224
    rng = np.random.default_rng(SEED + 2)
    boot = BioEMEngine(p, orients, model, ImageStack(images.maps[:1]),
                       RunConfig(use_kernels=True, autotune=False), device=DEVICE)
    maps, rot_star, d_star, half, o_base = _planted_offgrid(boot, 8, rng)
    del boot
    planted = ImageStack(maps)
    res_g, perf_g = run_bioem(p, orients, model, planted, RunConfig(use_kernels=True,
                              autotune=False), device=DEVICE)
    eng = perf_g["engine"]
    t0 = time.perf_counter()
    ref = refine_results(eng, res_g)
    t_pl = time.perf_counter() - t0
    seed_rot = rotation_matrices(torch.as_tensor(orients.angles[res_g.best_orient]),
                                 True).double().numpy()
    a_seed = np.array([_angle(seed_rot[i], rot_star[i]) for i in range(8)])
    a_ref = np.array([_angle(ref.rotmat[i], rot_star[i]) for i in range(8)])
    d_seed = np.hypot(res_g.best_cent_x - d_star[:, 0], res_g.best_cent_y - d_star[:, 1])
    d_ref = np.hypot(ref.cent_x - d_star[:, 0], ref.cent_y - d_star[:, 1])
    closer = (a_ref < a_seed) & (d_ref < d_seed)
    say(f"[refinement] 8 images planted off-grid (half step {half:.4f} rad, sub-pixel "
        f"displacements): refined in {t_pl:.3f} s; rotation error seed → refined "
        + ", ".join(f"{a:.4f}→{b:.4f}" for a, b in zip(a_seed, a_ref))
        + "; displacement error " + ", ".join(f"{a:.3f}→{b:.3f}" for a, b in zip(d_seed, d_ref))
        + f"; both closer on {int(closer.sum())}/8")
    require(int(closer.sum()) >= 7, "refinement got closer to the truth on fewer than 7 of 8")

    # 2 images on the card against the port on the CPU (same engine inputs),
    # the seed start run to convergence (the parity tolerances hold for
    # converged points; mid-climb the f32 paths' differences move values
    # by 1e-3–1e-2): the first two whose grid seed is the orientation
    # their plant was turned from, half a step away
    base_rot = rotation_matrices(torch.as_tensor(orients.angles[o_base]), True).double().numpy()
    sel = [i for i in range(8) if _angle(seed_rot[i], base_rot[i]) < 1e-3][:2]
    require(len(sel) == 2, "fewer than two plants were seeded at their base orientation")
    kw = dict(n_starts=1, iters=40)
    card_r = refine_results(eng, res_g, image_indices=np.array(sel), **kw)
    cpu_eng = BioEMEngine(p, orients, model, ImageStack(maps[sel]),
                          RunConfig(use_kernels=True, autotune=False), device="cpu")
    sub = copy.copy(res_g)
    for f in ARGMAX:
        setattr(sub, f, getattr(res_g, f)[sel])
    t0 = time.perf_counter()
    cpu_r = refine_results(cpu_eng, sub, **kw)
    t_cpu = time.perf_counter() - t0
    dlp = np.abs(card_r.logpro_refined - cpu_r.logpro_refined)
    tol = 1e-4 + 2e-7 * np.abs(cpu_r.logpro_refined)
    d_rot = max(_angle(card_r.rotmat[i], cpu_r.rotmat[i]) for i in range(2))
    d_d = float(max(np.abs(card_r.cent_x - cpu_r.cent_x).max(),
                    np.abs(card_r.cent_y - cpu_r.cent_y).max()))
    dseed = float(np.max(np.abs(card_r.logpro_seed - cpu_r.logpro_seed)
                         / np.abs(cpu_r.logpro_seed)))
    say(f"[refinement] images {sel}, the seed start × 40 iterations, card vs CPU ({t_cpu:.1f} s "
        f"on the CPU): logpro_refined {', '.join(f'{x:.4f}' for x in card_r.logpro_refined)} "
        f"(grad_norm {', '.join(f'{x:.2e}' for x in card_r.grad_norm)}), "
        f"|Δ logpro_refined| {', '.join(f'{x:.2e}' for x in dlp)} (limits "
        f"{', '.join(f'{x:.2e}' for x in tol)}), rel |Δ logpro_seed| {dseed:.2e} (1e-6), "
        f"rotation {d_rot:.2e} rad (2e-3), displacement {d_d:.2e} px (1e-2)")
    require(bool(np.all(dlp <= tol)) and dseed <= 1e-6 and d_rot <= 2e-3 and d_d <= 1e-2,
            "the card's refinement differs from the CPU's beyond the parity tolerances")
    del eng, perf_g, cpu_eng

    # --Refine through the CLI on golden case A
    with _in_case("case_a_euler_ctf", {}):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["--Modelfile", "model.txt", "--Particlesfile", "maps.txt",
                           "--Inputfile", "param.txt", "--Refine"])
        require(rc == 0, f"--Refine returned {rc}")
        rows = _parse_refined(open("Output_Refined").read())
    say(f"[refinement] --Refine on golden case A through the CLI: {rows.shape[0]} rows of "
        f"Output_Refined, all finite: {bool(np.isfinite(rows).all())}")
    require(rows.shape[0] > 0 and rows.shape[1] == 13 and bool(np.isfinite(rows).all())
            and bool(np.all(rows[:, 2] >= rows[:, 1])), "Output_Refined is not finite")
    return out


def phase_probes() -> dict:
    """P1–P3 through the probe tool's functions, each held to its check;
    returns their kernel rows."""
    from bioem_tpu_torch.tools import kernel_probe as kp
    from bioem_tpu_torch.tools.problem import bound, compare_bound

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
        ratio = p1["tf32_bound_ratio"][shape]
        require(ratio <= 1.0 and p1["copies_equal"][shape]["tf32"],
                f"P1 tf32 at {p1['shapes'][shape]}: largest |Δ| from the plain version "
                f"{ratio:.3f} of its rounding bound (limit 1), batch copies "
                f"{'equal' if p1['copies_equal'][shape]['tf32'] else 'DIFFER'}")
    bounds = p1_bounds(*p1["shapes"]["k4_stage1"])
    lib = p1["library_ms"]["k4_stage1"]
    for scheme, (b_ms, b_by) in bounds.items():
        t = p1["ms"]["k4_stage1"][scheme]
        log(f"P1 {scheme} at K4's stage-1 shape: {t:.4f} ms on the card, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / t:.1f} % of bound; torch.matmul f32 {lib:.4f} ms "
            f"({t / lib:.2f}x its time)")
    p2 = kp.probe_issue_overhead(say=log)
    for st in ("loop", "batched"):
        require(p2["err"][st] <= p2["tol"][st], f"P2 {st}: beyond its f32 summation tolerance")
    p3 = kp.probe_body_ablation(say=log)
    require(all(p3["bit_equal"].values()),
            f"P3: the full variant differs from the production kernel: {p3['bit_equal']}")

    b1 = bounds["3xtf32"]
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


# ---------------------------------------------------------------------------
# The accuracy, scale and profiling tools (bioem_tpu_torch/tools, examples)
# ---------------------------------------------------------------------------

# tests/test_golden.py's test_engine_beats_reference_precision: the engine
# within these of the f64 oracle, and 50× inside the reference's own error.
ORACLE_ATOL = {"case_l_n64": 2e-5, "case_n_n224": 5e-6}
ORACLE_RATIO = 50.0


def phase_accuracy(card: str) -> list:
    """``accuracy_probe.probe`` (the CLI and ``golden_error_budget.budget``)
    on case L (N = 64) and case N (N = 224) under the plain branch, K1, K4
    forced and the hybrid, on the case's maps (the f32 gate sends the
    kernel configurations to the hybrid there) and normalised (where K1
    and K4 run): every row's engine–oracle gap below oracle–golden / 50;
    the plain branch's also below the JAX test's absolute limits. Each
    kernel row prints its gap beside those limits and beside its gap from
    the plain branch; returns the rows."""
    from bioem_tpu_torch.tools.accuracy_probe import probe

    rows = []
    for case, atol in ORACLE_ATOL.items():
        for r in probe(case, device=DEVICE):
            ratio_lim = r["oracle_vs_f32_golden"] / ORACLE_RATIO
            worst = max(r["engine_vs_oracle"], r["engine_vs_oracle_normalized"])
            say(f"[accuracy] {card}: {case} {r['config']} (ran {r['ran']}; normalised ran "
                f"{r['ran_normalized']}): CLI vs f32 golden {r['cli_vs_f32_golden']:.4f}, vs f64 "
                f"golden {r['cli_vs_f64_golden']:.4f}; engine vs oracle {r['engine_vs_oracle']:.3e}"
                f", normalised {r['engine_vs_oracle_normalized']:.3e} (JAX limit {atol:g}; "
                f"oracle vs golden / 50 = {ratio_lim:.3e}); vs the plain branch "
                f"{r['engine_vs_plain']:.3e}, normalised {r['engine_vs_plain_normalized']:.3e}"
                + ("" if worst < atol else "; ABOVE the JAX absolute limit"))
            require(r["ran_normalized"] == r["config"],
                    f"{case} {r['config']}: the normalised maps ran {r['ran_normalized']}")
            require(worst < ratio_lim, f"{case} {r['config']}: engine vs oracle {worst:.3e} not "
                    f"50× inside the reference's own error")
            if r["config"] == "plain":
                require(worst < atol, f"{case}: the plain branch's engine vs oracle "
                        f"{worst:.3e} beyond the JAX limit {atol:g}")
            rows.append(r)
    return rows


def phase_examples(card: str) -> None:
    """Planted recovery (in this process) and the tutorial (its CLI and
    ranking steps in processes of their own), each required to pass. The
    planted scenario's second image is raw unit noise, as in the JAX
    example: the engine's f32 gate sends it to the hybrid (K3)."""
    from bioem_tpu_torch.examples import planted_recovery, tutorial

    out = planted_recovery.run(device=DEVICE, say=lambda m: say(f"[examples] planted: {m}"))
    require(out["recovered"] and out["refined"], "planted recovery failed")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        won = tutorial.run(work, say=lambda m: [say(f"[examples] tutorial: {ln}")
                                                for ln in m.splitlines() if ln.strip()])
    say(f"[examples] {card}: tutorial {time.perf_counter() - t0:.1f} s")
    require(won, "the tutorial's generating model did not rank first")


def phase_profile_tools(problem, card: str, n_blocks: int = 8) -> None:
    """profile_block and trace_step on the default kernel pass (K1,
    o_block 8): K1 and K2 named in the trace, its rows with ``other``
    within 5 % of the profiler's device time."""
    from bioem_tpu_torch.tools import profile_block, trace_step

    out = profile_block.profile(profile_block.engine_for(problem, device=DEVICE))
    profile_block.report(out, say=lambda m: say(f"[profile_block] {card}: {m}"))
    tr = trace_step.trace(profile_block.engine_for(problem, device=DEVICE), n_blocks=n_blocks)
    trace_step.report(tr, say=lambda m: say(f"[trace_step] {m}"))
    names = " ".join(r[0] for r in tr["rows"])
    require(tr["fallback"] is None, tr["fallback"] or "")
    require("compare_fused_kernel" in names and "project_kernel" in names,
            "the trace does not name K1 and K2")
    dev_ms = tr["profiler_total_ms"]
    require(abs(tr["rows_total_ms"] - dev_ms) <= 0.05 * dev_ms,
            f"the trace's rows sum to {tr['rows_total_ms']:.3f} ms against {dev_ms:.3f}")


def phase_scale(card: str) -> None:
    """scale_bench at 4608 and 36864 orientations, per-angle slabs off and
    on: finite logP everywhere, the peak memory of every run."""
    from bioem_tpu_torch.tools import scale_bench

    for n in (4608, 36864):
        for wa in (0, 30):
            rec = scale_bench.run_one(n, wa, device=DEVICE)
            say(f"[scale] {card}: {scale_bench.json_line(rec)}")
            require(rec["logp_finite"], f"scale {n} slabs {wa}: non-finite logP")
            require(rec["peak_card_mb"] is not None, f"scale {n}: no peak memory")


def phase_stream_cut(card: str, n_images: int = 2048, chunk: int = 1024) -> None:
    """stream_50k cut to ``n_images`` images (2 chunks of 1024) at 4608
    orientations: one capture, finite logP (the tool raises otherwise)."""
    from bioem_tpu_torch.tools import stream_50k

    rec, _ = stream_50k.stream(n_images, chunk, n_orient=4608, device=DEVICE)
    say(f"[stream] {card}: {json.dumps(rec)}")
    require(rec["captures"] == 1, f"the streamed chunks captured {rec['captures']} times")


def phase_small_tools(problem, card: str, depth: int = MESH_DEPTH) -> None:
    """At ``depth`` orientations: rank_bench with 3 models (reuse faster
    than the naive estimate), mesh_scale_bench up to 4 slots on the one
    card (its self-check), pipeline_lab's fused and hybrid pipelines on
    the production block, noise_recovery_table at 1 trial, levels 0 and 1."""
    from bioem_tpu_torch.tools import (mesh_scale_bench, noise_recovery_table, pipeline_lab,
                                       profile_block, rank_bench)

    rec, _ = rank_bench.bench(3, 64, depth, device=DEVICE)
    say(f"[rank_bench] {card}: {json.dumps(rec)}")
    require(rec["reuse_total_s"] < rec["naive_estimate_s"], "reuse is not faster than naive")
    mesh_scale_bench.ladder(4, depth, 64, device=DEVICE, say=lambda m: say(f"[mesh_scale] {m}"))
    lab = pipeline_lab.lab(profile_block.engine_for(problem, device=DEVICE))
    for name, r in lab.items():
        say(f"[pipeline_lab] {card}: {name}: {r['device_ms']:.4f} ms/step on the card "
            f"({r['event_ms']:.4f} ms CUDA events), {r['comparisons_per_s']:.4e} comparisons/s")
    require(all(lab[k]["device_ms"] > 0 for k in ("fused", "hybrid")),
            "pipeline_lab did not run both pipelines")
    rows = noise_recovery_table.table(1, levels=(0.0, 1.0), device=DEVICE,
                                      say=lambda m: say(f"[noise] {m}"))
    say("[noise] " + noise_recovery_table.markdown(rows).replace("\n", " "))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--mp-worker":  # phase_multiprocess's workers
        return mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
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
        card = phase_environment(torch)
        phase_build()

        from bioem_tpu_torch.config import RunConfig
        from bioem_tpu_torch.core.engine import BioEMEngine
        from bioem_tpu_torch.ops import compare_cuda as cc_mod
        from bioem_tpu_torch.ops import project_cuda as pj
        from bioem_tpu_torch.tools.problem import build_problem

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
            t0 = time.perf_counter()
            out = drive()
            say(f"[main path] {name} launches: "
                + ", ".join(f"{k} {fn.launches}" for k, fn in counters.items())
                + f"; {time.perf_counter() - t0:.1f} s")
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
        main_path("streaming", lambda: phase_streaming(problem, res_k, card), ("K1", "K2"))
        main_path("ranking", lambda: phase_ranking(problem, card), ("K1", "K2"))
        ref_2x2 = main_path("mesh", lambda: phase_mesh(problem, res_k, card), ("K1", "K2"))
        # the two worker processes' counters start at 0 with the processes
        for k, n in phase_multiprocess(ref_2x2, problem[3].maps, card).items():
            rows[k]["launches"] = rows[k].get("launches", 0) + n
        phase_native(card)
        main_path("refinement", lambda: phase_refinement(problem, card), ("K2",))
        from bioem_tpu_torch.ops import probe_cuda

        counters.update(P1=probe_cuda.f32_product, P2=probe_cuda.product_sum,
                        P3=probe_cuda.body_ablation)
        probe_rows = main_path("probe tool", phase_probes, ("P1", "P2", "P3"))
        for k, r in probe_rows.items():
            rows[k] = {**r, "launches": counters[k].launches}
        phase_bestmap()
        main_path("DEBUG_PROB", phase_debug_prob, ("K3",))
        main_path("accuracy", lambda: phase_accuracy(card), ("K1", "K3", "K4"))
        main_path("examples", lambda: phase_examples(card), ("K2", "K3"))
        main_path("profile tools", lambda: phase_profile_tools(problem, card), ("K1", "K2"))
        main_path("scale", lambda: phase_scale(card), ("K1", "K2"))
        main_path("stream cut", lambda: phase_stream_cut(card), ("K1", "K2"))
        main_path("rank, mesh, pipeline, noise", lambda: phase_small_tools(problem, card),
                  ("K1", "K2", "K3"))
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
