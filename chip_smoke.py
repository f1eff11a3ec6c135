#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``bioem_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bioem_tpu_torch/csrc`` and drives
the port's main path on the card, in phases (each prints its own lines):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: nvcc of every kernel, with its seconds and ptxas resource lines
   (each kernel's registers, spills and static shared memory; G1's and
   G2's summed up on a line each);
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
   same bits; K1 and K3 on lattices the earlier K1 refused or ran on two
   warpgroups (N = 224, D = 121; N = 512, D = 81: two warpgroups, the
   lattice in wide row chunks), K1 at D = 121 timed beside its bound; the
   posterior glue: G1 (the block constants) and G2 (the f64 max repair
   and the streaming merge) against their plain versions at the
   production block (G2 on K1's outputs, into a fresh state and again
   into the state it made), at o_block 16 and at a reference-grid block
   (C = 32) on random inputs (G1 on normalised and DC-dominated images,
   G2 on the fused path, the hybrid's f32 m, a partially and a fully
   masked block and exact ties, slabs off and on; f0, k, a_u, b_u and
   the repaired max at 0 ulps, total within 1.5e-7), three replays of a
   captured G1 + G2 step whose offset the graph advances (G1's ticket
   counting its launches), and both timed at the production block
   (kernel_probe.glue_attribution) beside a one-kernel floor, their plain
   versions and bounds; the projection's
   prologue G3 (rotation matrices, snap, bounds masks, regroup and the
   scale norm_den/tempden) against its plain version on the production
   block, an Euler-grid block, o_block 16, a reference-grid block and a
   model with points out of the frame in both branches (snaps equal but
   at ties within 2 ulps, the slots that differ counted; densities equal
   where the snaps are; the scale within 1e-6), K2 storing G3's scale
   bit-equal to K2 times it, two replays of a captured G3 + K2 bit-equal
   to the eager calls, G3 timed beside its plain version and bound; the
   raster projection G4 (rotation matrices, snap, stencil weights, their
   deposit in model order and the scale) against its plain version on the
   same five kinds of block of the model laid out for the raster (snaps
   equal but at ties; the projection within 1e-6 of its max |pixel|; the
   scale within 1e-6; two launches bit-equal), G4 timed beside its plain
   version, its bound and cuFFT's rfft2 of its output;
4. the reference-binary goldens (tests/golden/data) through the port's CLI;
5. the production-shape posterior run (4352 orientations × 8 CTFs × 64
   images at N=224) through run_bioem: on the kernel branch with K1 (then
   32 of its blocks as the eager loop and as replays of the captured
   block step, each timed and under torch.profiler: wall time, the
   card's busy share, kernels per block and the glue by phase; and a new
   engine's capturing pass split into set-up, capture and replays),
   with K4 forced (BIOEM_TPU_FUSED_BATCHED), and
   autotuned three times from an empty cache and once more from the cache
   (each candidate's time on its replayed loop, each winner and its pass
   time printed; each pass with the seconds its tuning took; the autotune
   cache is a temporary file, never the working directory's), each against
   the plain branch on the same card; then a checkpoint round trip (stop
   after half the blocks, resume under replay in a fresh engine) against
   the straight run;
6. the raster projection: the production problem with
   RunConfig(projection="raster") on the plain branch and the kernel
   branch (G4, then K1; replayed), argmax tuples equal (q against −q as
   one rotation: the plain branch's atomics break their exact tie), finite
   logP, and logP against step 5's Fourier kernel pass within
   RASTER_VS_FOURIER, and the two passes side by side (best of 3 replayed
   passes each, in turns);
   rank_models at 1088 orientations of the production model and a
   continuous-radius candidate (its 500 radii made distinct: the raster
   for both), one capture, each model equal to its own raster engine; the
   replayed raster block under torch.profiler, before (the plain raster
   projection inside the kernel branch) and after (G4): kernels, wall and
   busy ms per block, the projection phase's kernels and µs;
6b. voxel maps (--ReadModelMRC models: every voxel a sphere of radius
   2·pix): G4's weights and snaps bit-equal to the plain version's where no
   stencils meet (kernel_probe.check_raster_sparse; also at a reach past
   the deposit's octant table), 32³ and 48³ maps against the plain version
   (check_raster), rows 0 and 7 of a block of a 224³ map (11,239,424
   voxels) against it; G4's lattice variant on 32³, 48³ and 33 × 40 × 27
   maps (axis-aligned, 45° and diagonal views, q and −q, shifts) and on
   those rows against the plain version and the generic variant
   (check_raster_lattice: snaps bit-equal, scales within one ulp); that
   block twice in each variant, bit-equal, with its card time, the
   card's out-of-frame census of the 32³ map and of the 224³ map (16 of the
   grid's orientations) against projection_oob_report, and the path rule's
   timings (kernel_probe.path_rule_times: G3 + K2 against G4 + rfft2 per
   block, 500 residues and 500 to 11.2 M voxels);
7. streaming: the 64 production images through run_streaming in chunks of
   16 on K1, one capture for all chunks, equal to the K1 run_bioem of
   step 5; a checkpointed streamed run that dies reading chunk 2, resumed,
   equal to the straight streamed run;
8. ranking: rank_models with the production model against it jittered by
   2 Å and with 50 points removed (other per-group point counts, which
   K2 reads per model), one capture for the three, each candidate equal
   to its own run_bioem, the production model first;
9. refinement: refine_results after the tuned pass on as many production
   images as fit its time budget (the cut printed), every refined logpro
   at or above its seed; 8 images planted off-grid with the smooth
   forward model at N = 224, the refined rotation and displacement closer
   to the truth than the grid seed on ≥ 7; 2 of them refined on the card
   and on the CPU, held to the CPU parity test's tolerances; --Refine
   through the port's CLI on golden case A;
10. the kernel probe tool (bioem_tpu_torch.tools.kernel_probe): P1 (the
   f32 product's accuracy by scheme, and each scheme's card time at K4's
   stage-1 shape beside its bound and torch.matmul f32's), P2 (looped vs
   batched products on wgmma across the card, beside one cuBLAS GEMM
   doing all of them) and P3 (the K1/K4 body ablation at the production block),
   each held to its check;
11. --PrintBestCalMap on golden case M through the port's CLI, held to
   tests/test_golden.py's BESTMAP rule;
12. DEBUG_PROB: golden case L (N=64) through the port's CLI twice, dumping
   one image on the plain branch and through K3, diffed with the port's
   diff entry point, and the dump's log-sum-exp held to the image's logP;
13. the (images × orientations) mesh (after ranking): the production
   problem on a 2×2 mesh of four slots on the one card (K1, each slot its
   own captured graph), held to the single engine's K1 pass at |ΔlogP| ≤
   1e-10·max|logP| (and the per-angle logP), argmax tuples equal, four
   captures, twice (the second pass replays only), each pass's wait for
   the card, merge and garbage-collector pauses printed; then 2×2, 1×4
   and 4×1 at 1088 orientations, held the same way;
14. multi-process: two processes of this script (``--mp-worker``) on the
   card over gloo, two slots each of a global 2×2 mesh at 1088
   orientations: the pass bit-equal to the one-process 2×2 run; a run
   streamed in 2 chunks in which each process reads only its rows; a
   checkpointed run stopped mid-slot and resumed;
15. the native C++ ingest: a 2048-image 224² MRC stack (~411 MB) and a
   500-point text model read natively and with NumPy, bit-equal, both
   times printed;
16. accuracy: tools/accuracy_probe (the CLI and golden_error_budget) on
   golden cases L (N = 64) and N (N = 224) under the plain branch, K1, K4
   forced and the hybrid, on the cases' maps and normalised (where K1 and
   K4 pass the f32 gate): each engine within oracle–golden / 50 of the
   all-f64 oracle, the plain branch also within the JAX suite's 2e-5 and
   5e-6;
17. examples: planted recovery and the tutorial (its CLI and ranking in
   processes of their own), both passing;
18. tools/profile_block and tools/trace_step on 8 replayed production
   blocks, on the Fourier path and on the raster: every kernel at ≥ 1 %
   by name (K1 and K2, or K1 and G4, among them), the rest as
   ``other``, within 5 % of the profiler's device time, and the glue
   grouped by the block step's phase and the torch op that launched it;
19. tools/scale_bench at 4608 and 36864 orientations, per-angle slabs off
   and on: comparisons/s, peak card memory, finite logP;
20. tools/stream_50k cut to 2048 images in 2 chunks of 1024 at 4608
   orientations: one capture, finite logP, peak card memory;
21. at 1088 orientations: tools/rank_bench (3 models, reuse faster than
   the naive estimate), tools/mesh_scale_bench (1 to 4 slots on the one
   card, each within 1e-6·max|logP| of one slot), tools/pipeline_lab
   (the fused and hybrid pipelines' device time per step) and
   tools/noise_recovery_table (1 trial at noise 0 and 1);
22. the benchmark harness (bioem_tpu_torch.tools.bench, in this process,
   tuned from an empty autotune cache) on bench.py's own problem (raw
   noise: the hybrid runs) and on the planted production problem (K1 or
   K4): one JSON line each with every key, the card named, the pass at or
   below 100 % of its bound;
23. the reference's production grid: K1 and K3 at its block (D = 81,
   M = 224: two warpgroups, plan (2, 8, 3)) against their plain versions and
   K1 timed beside its bound (the kernels line's ``fused_compare_block
   (D=81)`` row); then 4608 quaternions × 32 CTFs × 64 planted images at
   D = 81 through the port's CLI (--ReadOrientation, --ReadMRC): K1 at
   plan (2, 8, 3), K4 never, finite logP, the planted orientation and CTF
   recovered; and a cut of ~128 orientations on the plain branch, K1 and
   the hybrid with argmax tuples equal;
24. the wide grid (the reference grid searching ±60 pixels, D = 121):
   its cut of ~128 orientations × 32 CTFs × 64 planted images through the
   port's CLI on the kernel branch (K1 on two warpgroups, K4 never) and
   on the plain branch, argmax tuples equal, finite logP, the planted
   parameters recovered; and its C2 cut (2 images × 4 orientations × 32
   CTFs) on the plain branch, K1 and the hybrid (K3) against the f64
   oracle;
25. the C2 check: the production shape cut to 4 planted images × 16
   orientations × 8 CTFs, and the reference grid cut to 2 images × 4
   orientations × 32 CTFs, on every kernel configuration and the plain
   branch against the all-f64 oracle (tools/oracle.py, on the host): no
   kernel configuration farther from it than max(5e-6, the plain
   branch's gap).

The paths are driven in parts, each with every kernel's launch counter
set to 0 just before it and read just after: the goldens with the plain
and K1 passes must launch K1, K2 and K3; the K4, autotuned and checkpoint
passes K2 and K4; streaming, ranking and the mesh K1 and K2 (the
multi-process workers report theirs); the refinement phase (its grid
passes) K2; the probe tool P1, P2 and P3; the DEBUG_PROB runs
K3; the accuracy phase K1, K3 and K4; the raster K1 and G4; the examples K2 and K3; the profile
tools, scale and the stream cut K1 and K2; the last tools K1, K2 and K3; the
harness K2 and K3 on bench.py's problem, K2 and K1 or K4 on the planted one;
the reference grid and the wide grid K1, K2 and K3; the C2 check K1, K2,
K3 and K4; every one of them but the probe tool, DEBUG_PROB and the
examples also G1 and G2 (the kernel branch's block step), every one
but the probe tool and the raster G3 (the kernel projection's prologue),
and the goldens (case N), the raster, the accuracy phase and the profile
tools G4. Each part's
line gives its seconds.
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
    from bioem_tpu_torch.tools.bench import card_line

    card = card_line()
    require(bool(card), "nvidia-smi named no card")
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
    log = info.get("log", "").splitlines()
    for line in log:
        if ("entry function" in line or "Used" in line or "spill" in line
                or "wgmma" in line or "warning" in line.lower()):
            say(f"[build] {line.strip()}")
    # G1 and G2
    for name, stem in (("G1", "block_constants_kernel"), ("G2", "merge_block_kernel")):
        k = next((k for k, line in enumerate(log) if "entry function" in line and stem in line),
                 None)
        if k is not None:
            said = [x.split("info    :")[-1].strip() for x in log[k + 1:k + 5]
                    if "stack frame" in x or "Used" in x]
            say(f"[build] ptxas {name}: {'; '.join(said)}")
    # where their stack frames go: calls and local-memory traffic in SASS
    from bioem_tpu_torch.tools.kernel_probe import sass_counts

    for stem, n in sass_counts(info["path"], ("block_constants_kernel",
                                               "merge_block_kernel")).items():
        say(f"[build] SASS {stem}: " + ", ".join(f"{v} {k}" for k, v in n.items()))


def _block_inputs(eng, b: int = 0):
    """The kernel branch's inputs for orientation block ``b`` of an engine,
    from the plain projection (so a kernel is compared on inputs no kernel
    made)."""
    import torch

    from bioem_tpu_torch.core.orientations import rotation_matrices
    from bioem_tpu_torch.core.projection import grouped_snap, project_fourier_batch
    from bioem_tpu_torch.ops.posterior_cuda import block_constants_plain

    bk, p, fs = eng.banks, eng.p, eng.fspec
    rotm = rotation_matrices(eng.ang_blocks[b], eng.orients.use_quaternions)
    model = (bk.points, bk.radii, bk.dens)
    pr, pi = project_fourier_batch(fs, rotm, *model, bk.norm_den, bk.st_re, bk.st_im, bk.st_sums)
    i0, j0, de = grouped_snap(fs, rotm, *model)
    g1 = (pr, pi, bk.ctf_re, bk.ctf_im, bk.h, bk.sum_ref, bk.ssq_ref, eng._prior,
          eng.mask_blocks[b])
    g1_kw = dict(ntot=p.n_total_pixels, images_normalized=eng._f32_corr_ok)
    *_, a_u, b_u = block_constants_plain(*g1, **g1_kw)
    return dict(
        pr=pr, pi=pi, i0=i0, j0=j0, dens=de, a_u=a_u, b_u=b_u, g1=g1, g1_kw=g1_kw,
        counts=torch.tensor(fs.group_counts, dtype=torch.int32, device=de.device),
        wx_re=eng.wx_cols[0], wx_im=eng.wx_cols[1], a_coef=(3.0 - p.n_total_pixels) * 0.5,
    )


def check_compare(torch, name, args, a_coef, n_fold, img_tile=None, se_rtol=1.5e-4):
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
    require(s_rel <= se_rtol, f"{name}: se beyond rtol {se_rtol:.3g}")
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
    from bioem_tpu_torch.tools.problem import bound, cc_bound, compare_bound
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
    b3 = cc_bound(o, c, i_n, n, f, d, m, eng.n_fold)
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


# ---------------------------------------------------------------------------
# The posterior glue: G1 (block_constants) and G2 (merge_block)
# ---------------------------------------------------------------------------

def check_constants(torch, name, g1, kw, workspace=None) -> float:
    """G1 against its plain version on the card: sum_c bit-equal; ssq_c
    within 2e-6 relative and no farther from an all-f64 evaluation than
    the plain f32 product; f0, k, a_u, b_u at 0 ulps from the plain
    formulas on G1's own sums; masked k exactly −inf; two launches
    bit-equal. Returns max |Δssq_c| against the plain version (every other
    output is held to the bit)."""
    from bioem_tpu_torch.ops import posterior_cuda as G
    from bioem_tpu_torch.tools.kernel_probe import ulp_distance

    sum_c, ssq_c, f0, k, a_u, b_u = G.block_constants(*g1, **kw, workspace=workspace)
    again = G.block_constants(*g1, **kw, workspace=workspace)
    p_sum, p_ssq = G.convolution_sums_plain(*g1[:5], ntot=kw["ntot"])
    _s64, ssq64 = G.convolution_sums_plain(*(v.double() for v in g1[:5]), ntot=kw["ntot"])
    want = G.constants_from_sums(sum_c, ssq_c, *g1[5:], **kw)
    torch.cuda.synchronize()
    rel = float(((ssq_c - p_ssq).abs() / p_ssq.abs()).max())
    gap_k = float((ssq_c.double() - ssq64).abs().max())
    gap_p = float((p_ssq.double() - ssq64).abs().max())
    ulps = {n: ulp_distance(a, b) for n, a, b in zip(("f0", "k", "a_u", "b_u"), (f0, k, a_u, b_u), want)}
    live = g1[8] != 0
    masked_ok = bool((k[~live] == -torch.inf).all()) and bool(torch.isfinite(k[live]).all())
    bits = all(torch.equal(a, b) for a, b in zip((sum_c, ssq_c, f0, k, a_u, b_u), again))
    say(f"[glue] {name}: sum_c bit-equal {torch.equal(sum_c, p_sum)}; ssq_c max rel |Δ| "
        f"{rel:.2e}, from f64 {gap_k:.3e} against the plain product's {gap_p:.3e}; ulps "
        + ", ".join(f"{n} {u}" for n, u in ulps.items())
        + f"; masked k −inf {masked_ok} ({int((~live).sum())} of {live.numel()} masked); "
        f"two launches bit-equal {bits}")
    require(torch.equal(sum_c, p_sum), f"{name}: sum_c differs from the plain version")
    require(rel <= 2e-6, f"{name}: ssq_c beyond 2e-6 relative")
    require(gap_k <= gap_p, f"{name}: ssq_c farther from f64 than the plain version")
    require(all(u == 0 for u in ulps.values()), f"{name}: f0, k, a_u or b_u off the plain formulas")
    require(masked_ok, f"{name}: masked k not −inf or live k not finite")
    require(bits, f"{name}: two launches on the same inputs differ")
    return float((ssq_c - p_ssq).abs().max())


def check_merge(torch, name, base, args, o: int, ntot: float, expect_first=None) -> float:
    """G2 (offset a 0-d device tensor) against its plain version (an int
    offset O), each on its own copy of ``base``: the varying max used at
    0 ulps; const, the argmax tuple and ang_const exact; best_norm and
    best_mu within 1e-12 relative; total within 1.5e-7 relative and
    ang_total within 1e-6; a fully masked block leaves the state
    bit-equal. Returns max |Δtotal|."""
    from bioem_tpu_torch.ops import posterior_cuda as G
    from bioem_tpu_torch.tools.kernel_probe import ulp_distance

    kern, plain = (type(base)(*(x.clone() if x is not None else None for x in base))
                   for _ in range(2))
    m_k = torch.empty(args[4].shape, dtype=torch.float64, device=args[4].device)
    m_p = torch.empty_like(m_k)
    G.merge_block(kern, *args, torch.tensor(o, device=m_k.device), ntot=ntot, m_out=m_k)
    G.merge_block_plain(plain, *args, o, ntot=ntot, m_out=m_p)
    torch.cuda.synchronize()
    bad = []
    for f, a, b in zip(base._fields, kern, plain):
        if a is None:
            continue
        if f in ("total", "ang_total"):
            ok = bool(((a - b).abs() <= 1e-6 * b.abs()).all())
        elif f in ("best_norm", "best_mu"):
            ok = float(((a - b).abs() / b.abs().clamp_min(1e-300)).max()) <= 1e-12
        else:
            ok = torch.equal(a, b)
        if not ok:
            bad.append(f)
    masked = not bool(torch.isfinite(args[4]).any())
    unchanged = all(x is None or torch.equal(x, y) for x, y in zip(kern, base))
    updated = int((kern.best_orient != base.best_orient).sum())
    rel_t = float(((kern.total - plain.total).abs() / plain.total.abs()).max())
    say(f"[glue] {name}: m ulps {ulp_distance(m_k, m_p)}, total max rel |Δ| {rel_t:.2e}, "
        f"fields off their limits: {bad or 'none'}; tuples moved on {updated} images"
        + (f"; state unchanged {unchanged}" if masked else ""))
    require(ulp_distance(m_k, m_p) == 0, f"{name}: the varying max off refine_varying_max")
    require(not bad, f"{name}: {', '.join(bad)} off their limits")
    require(rel_t <= 1.5e-7, f"{name}: total beyond 1.5e-7 relative")
    require(not masked or unchanged, f"{name}: a fully masked block changed the state")
    if expect_first is not None:
        require(bool((kern.best_orient == expect_first).all() and (kern.best_conv == 0).all()),
                f"{name}: a tie did not go to the first pair")
    return float((kern.total - plain.total).abs().max())


def check_glue_replay(torch, i: int = 64, n_blocks: int = 3) -> None:
    """G1 and G2 captured in one CUDA graph, G1's workspace made before the
    capture, the block's offset a 0-d device tensor the graph advances:
    three replays on three blocks' inputs equal the eager calls with int
    offsets 0, O and 2·O, bit for bit, and G1's ticket counts the warm-up's
    and the replays' CTAs (kernel_probe.glue_replay)."""
    from bioem_tpu_torch.tools.kernel_probe import glue_replay

    state, eager, blk, ws = glue_replay(DEVICE, i=i, n_blocks=n_blocks)
    same = all(torch.equal(a, b) for a, b in zip(state, eager))
    late = int((state.best_orient >= 8).sum())
    tickets = int(ws.ticket[0])
    say(f"[glue] {n_blocks} replays of G1 + G2 with a device offset: bit-equal to the eager "
        f"calls {same}; blocks after the first hold the argmax of {late}/{i} images; G1's "
        f"ticket {tickets} after a warm-up and {n_blocks} replays of {ws.plan.grid} CTAs")
    require(blk == n_blocks and same and late > 0,
            "the replayed glue does not read its offset from the device")
    require(tickets == (1 + n_blocks) * ws.plan.grid, "G1's ticket is off its launches")


def glue_g3(torch, eng) -> dict:
    """G3 (project_prologue) against its plain version: on the production
    block as the engine holds it (its banks and first angle block) and on
    kernel_probe.prologue_inputs' other blocks (an Euler-grid block,
    o_block 16, a reference-grid block, points out of the frame in both
    branches), under the tie rule (kernel_probe.check_prologue: snaps equal
    but where the plain pre-floor value lies within 2 ulps of an integer,
    the number of such slots printed; densities equal where the snaps are;
    the scale within 1e-6 relative); K2 with G3's scale bit-equal to K2
    times it; two replays of a captured G3 + K2 bit-equal to the eager
    calls; G3's, its plain version's and K2's scaled and unscaled times at
    the production block, and G3's bound. Returns G3's kernels-line row."""
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.tools.kernel_probe import (PROLOGUE_CASES, check_prologue, device_ms,
                                                    prologue_inputs, prologue_replay)
    from bioem_tpu_torch.tools.problem import prologue_bound

    bk, fs = eng.banks, eng.fspec
    prod = dict(fspec=fs, angles=eng.ang_blocks[0], quat=eng.orients.use_quaternions,
                model=(bk.points, bk.radii, bk.dens, bk.norm_den), st_re=bk.st_re,
                st_im=bk.st_im, st_sums=bk.st_sums, counts=bk.counts)
    err = 0.0
    for case in PROLOGUE_CASES:
        x = prod if case == "production" else prologue_inputs(DEVICE, case)
        r = check_prologue(x)
        o_n = x["angles"].shape[0]
        say(f"[glue] G3 {case} (O={o_n}, G={x['fspec'].n_groups}, Pp={x['fspec'].group_pad}, "
            f"{'quaternions' if x['quat'] else 'Euler angles'}): {r['differ']} of {r['slots']} "
            f"slots snap elsewhere than the plain version, {r['off_tie']} of them off a tie; "
            f"densities off where the snaps agree {r['dens_off']}; scale max rel |Δ| "
            f"{r['scale_rel']:.2e} (from norm_den/tempden on G3's densities "
            f"{r['scale_rel_own']:.2e}); two launches bit-equal {r['bits']}; points dropped "
            f"out of the frame: {r['dropped']['point']} point-like, {r['dropped']['sphere']} "
            "spheres")
        require(r["off_tie"] == 0, f"G3 {case}: a snap differs away from a tie")
        require(r["dens_off"] == 0, f"G3 {case}: densities differ where the snaps agree")
        require(r["scale_rel"] <= 1e-6 and r["scale_rel_own"] <= 1e-6,
                f"G3 {case}: scale beyond rtol 1e-6")
        require(r["bits"], f"G3 {case}: two launches on the same inputs differ")
        if case == "out of frame":
            require(r["dropped"]["point"] > 0 and r["dropped"]["sphere"] > 0,
                    "G3 out of frame: no point dropped in one of the branches")
        if case == "production":
            err = r["scale_abs"]
    args = (fs, prod["angles"], *prod["model"], bk.st_sums)
    i0, j0, de, scale = pj.project_prologue(*args, use_quaternions=prod["quat"])
    kw = dict(n=fs.n_pixels, counts=bk.counts)
    ur, ui = pj.fourier_project_block(i0, j0, de, bk.st_re, bk.st_im, **kw)
    sr, si = pj.fourier_project_block(i0, j0, de, bk.st_re, bk.st_im, scale=scale, **kw)
    torch.cuda.synchronize()
    one = torch.equal(sr, ur * scale[:, None, None]) and torch.equal(si, ui * scale[:, None, None])
    say(f"[glue] K2 with G3's scale bit-equal to K2 times the scale: {one}")
    require(one, "K2's scaled store differs from the unscaled spectra times the scale")
    replayed, eager = prologue_replay(DEVICE)
    same = all(torch.equal(a, b) for got, want in zip(replayed, eager) for a, b in zip(got, want))
    moved = not torch.equal(replayed[0][0], replayed[1][0])
    say(f"[glue] two replays of G3 + K2 on two angle blocks: bit-equal to the eager calls "
        f"{same}; the blocks differ {moved}")
    require(same and moved, "the replayed G3 + K2 do not follow their angle block")
    t = (device_ms(lambda: pj.project_prologue(*args, use_quaternions=prod["quat"])),
         device_ms(lambda: pj.project_prologue_plain(*args, use_quaternions=prod["quat"]), 5))
    k2 = (device_ms(lambda: pj.fourier_project_block(i0, j0, de, bk.st_re, bk.st_im, **kw)),
          device_ms(lambda: pj.fourier_project_block(i0, j0, de, bk.st_re, bk.st_im,
                                                     scale=scale, **kw)))
    b3 = prologue_bound(prod["angles"].shape[0], fs.n_groups, fs.group_pad)
    say(f"[glue] G3 production-block time: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms (the "
        f"card's own time); bound {b3[0]:.6f} ms ({b3[1]}-bound); K2 unscaled {k2[0]:.4f} ms, "
        f"with the scale {k2[1]:.4f} ms")
    return dict(name="project_prologue", route="cuda",
                source="bioem_tpu_torch/csrc/project_glue.cu",
                replaces="bioem_tpu/core/projection.py:302-330,444-461; "
                         "bioem_tpu/core/orientations.py:138-202 (XLA-fused; no Pallas kernel)",
                max_abs_err=err, ms=t[0], plain_ms=t[1], bound_ms=b3[0], bound_by=b3[1],
                library_ms=None)  # no single PyTorch call computes G3


def glue_g4(torch) -> dict:
    """G4 (raster_project) against its plain version (rotation_matrices,
    then project_batch: index_add_'s atomics) on the blocks of
    kernel_probe.raster_inputs: the production block, an Euler-grid block,
    o_block 16, a reference-grid block and the model spread twice as far
    with every other point point-like (points out of the frame in both
    branches), as the engine lays the model out on the raster. Under
    kernel_probe.check_raster: snaps equal but where the plain pre-floor
    value lies within 2 ulps of an integer (the pairs that differ counted);
    on the orientations whose snaps all agree, the projection within 1e-6
    of the plain version's max |pixel| (model order against the atomics'
    order) and the scale within 1e-6 relative; two launches bit-equal. G4's
    and its plain version's time at the production block, cuFFT's rfft2 of
    its output (the transform G4 feeds), and G4's bound. Returns G4's
    kernels-line row."""
    from bioem_tpu_torch.tools.kernel_probe import (PROLOGUE_CASES, check_raster,
                                                    raster_inputs, raster_times)
    from bioem_tpu_torch.tools.problem import raster_bound

    for case in PROLOGUE_CASES:
        x = raster_inputs(DEVICE, case)
        r = check_raster(x)
        o_n, p_n = x["angles"].shape[0], x["model"][0].shape[0]
        say(f"[glue] G4 {case} (O={o_n}, P={p_n}, stencil_half {x['spec'].stencil_half}, "
            f"{'quaternions' if x['quat'] else 'Euler angles'}): {r['differ']} of {r['pairs']} "
            f"points snap elsewhere than the plain version, {r['off_tie']} of them off a tie; "
            f"projection max |Δ| {r['proj_rel']:.2e} of max |pixel| ({r['proj_abs']:.3e}); "
            f"scale max rel |Δ| {r['scale_rel']:.2e}; two launches bit-equal {r['bits']}; "
            f"points dropped out of the frame: {r['dropped']['point']} point-like, "
            f"{r['dropped']['sphere']} spheres")
        require(r["off_tie"] == 0, f"G4 {case}: a snap differs away from a tie")
        require(r["proj_rel"] <= 1e-6, f"G4 {case}: projection beyond 1e-6 of max |pixel|")
        require(r["scale_rel"] <= 1e-6, f"G4 {case}: scale beyond rtol 1e-6")
        require(r["bits"], f"G4 {case}: two launches on the same inputs differ")
        if case == "out of frame":
            require(r["dropped"]["point"] > 0 and r["dropped"]["sphere"] > 0,
                    "G4 out of frame: no point dropped in one of the branches")
        if case == "production":
            prod, err = x, r["proj_abs"]
            b4 = raster_bound(o_n, x["spec"].n_pixels, p_n, x["spec"].stencil_half, r["live"])
    t = raster_times(prod)
    say(f"[glue] G4 production-block time: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms "
        f"(the card's own time); bound {b4[0]:.6f} ms ({b4[1]}-bound); cuFFT's rfft2 of its "
        f"output {t['rfft2_ms']:.4f} ms")
    return dict(name="raster_project", route="cuda",
                source="bioem_tpu_torch/csrc/project_raster.cu",
                replaces="bioem_tpu/core/projection.py:74-195; bioem_tpu/core/engine.py:484 "
                         "(XLA-fused; no Pallas kernel)",
                max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b4[0],
                bound_by=b4[1], library_ms=None)  # no single PyTorch call computes G4


def phase_glue(torch, eng) -> dict:
    """G1 and G2 against their plain versions: on the production block
    (:func:`_block_inputs`; G2 on K1's outputs there, into a fresh
    state and again into the state it made, where every block max ties
    const and the strict > moves nothing), and on random blocks at
    o_block 16 and at a reference-grid block (C = 32), G1 on normalised
    and DC-dominated images, G2 in every case of kernel_probe.GLUE_CASES
    with the slabs off and on; three replays of a captured step with a
    device offset; the kernels' times beside a one-kernel floor
    (kernel_probe.glue_attribution), the plain versions' times and the
    bounds at the production block."""
    from bioem_tpu_torch.core.posterior import init_state, refine_varying_max
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import posterior_cuda as G
    from bioem_tpu_torch.tools.kernel_probe import (GLUE_CASES, device_ms, glue_attribution,
                                                    glue_inputs, glue_merge_args)
    from bioem_tpu_torch.tools.problem import bound

    bk, p = eng.banks, eng.p
    o, c, n, f = eng.o_block, eng.n_ctf, p.n_pixels, p.n_fft_1d
    i_n = bk.img_re.shape[0]
    ntot = float(p.n_total_pixels)
    x = _block_inputs(eng)
    err1 = check_constants(torch, "G1 production block", x["g1"], x["g1_kw"], eng._g1_workspace)
    k1_args = (x["pr"], x["pi"], bk.ctf_re, bk.ctf_im, bk.img_re, bk.img_im,
               x["wx_re"], x["wx_im"], bk.wy_re, bk.wy_im, x["a_u"], x["b_u"])
    _m, se, ds, ccs = (v.reshape(o, c, i_n) for v in cc_mod.fused_compare_block(
        *k1_args, a_coef=x["a_coef"], n_fold=eng.n_fold))
    sum_c, ssq_c, f0, k, _a, _b = G.block_constants_plain(*x["g1"], **x["g1_kw"])
    args = (None, se, ds, ccs, k, f0, sum_c, ssq_c, bk.sum_ref, bk.disp)
    fresh = init_state(i_n, 2 * o, True, DEVICE)
    err2 = check_merge(torch, "G2 production block, fresh state", fresh, args, o, ntot)
    again = type(fresh)(*(v.clone() for v in fresh))
    G.merge_block_plain(again, *args, 0, ntot=ntot)
    check_merge(torch, "G2 production block, again (ties with const)", again, args, o, ntot)
    for shape in ((16, 8, 64), (8, 32, 64)):
        for normalized in (True, False):
            g = glue_inputs(DEVICE, *shape, normalized=normalized)
            check_constants(torch, f"G1 O,C,I={shape} "
                            f"{'normalised' if normalized else 'DC-dominated'}", g["g1"], g["kw"])
        g = glue_inputs(DEVICE, *shape)
        for slabs in (False, True):
            base = init_state(shape[2], 2 * shape[0], slabs, DEVICE)
            G.merge_block_plain(base, *glue_merge_args(glue_inputs(DEVICE, *shape, seed=7),
                                                       "fused"), 0, ntot=g["kw"]["ntot"])
            for case in GLUE_CASES:
                check_merge(torch, f"G2 O,C,I={shape} {case}, slabs {'on' if slabs else 'off'}",
                            base, glue_merge_args(g, case), shape[0], g["kw"]["ntot"],
                            expect_first=shape[0] if case == "ties" else None)
    check_glue_replay(torch)

    # Times, the card's own time (kernel_probe.glue_attribution: the calls
    # queued behind a ~20 ms spin of the card, which hides the host's
    # launches; G2's offset a 0-d tensor on the card, as the captured step
    # passes it): G1 and G2 at the production block, with the engine's
    # workspace, beside a one-kernel floor. The plain versions' 50–90 torch
    # ops each: 5 calls, so that their launches stay inside the spin.
    att = glue_attribution(x["g1"], x["g1_kw"], args, eng._g1_workspace)
    for label, ms in att.items():
        say(f"[glue] production block, card time: {label} {ms:.5f} ms")
    st = init_state(i_n, 2 * o, False, DEVICE)
    t = {"G1": (att["G1"], device_ms(lambda: G.block_constants_plain(*x["g1"], **x["g1_kw"]), 5)),
         "G2": (att["G2 slabs off"],
                device_ms(lambda: G.merge_block_plain(st, *args, 0, ntot=ntot), 5))}
    # Bounds: G1 reads the spectra once and writes its outputs once; its
    # f64 work is |p|² and |ctf|² per frequency and a multiply-add per (o,
    # c, frequency), ~20 operations per (o, c, i) row entry. G2 on the
    # fused path (no m) reads se, ccs, k and f0 per (o, c, i), sum_c per
    # (o, c) and sum_ref, reads and writes total and const, ~15 f64
    # operations per (o, c, i); only where the block's max beats const
    # strictly does it read ds, ssq_c and two displacements and write the
    # six-field tuple. The timed calls merge into a state that has this
    # block already (the first call), so count those images from the data.
    nf = n * f
    b1 = bound({"f64": 4 * o * nf + 3 * c * nf + 2 * o * c * nf + 20 * o * c * i_n},
               4 * (2 * (o + c) * nf + f + 2 * i_n + o) + 8 * c
               + 2 * 4 * o * c + 2 * 8 * o * c * i_n + 2 * 4 * o * c * i_n)
    block_max = (k + refine_varying_max(ccs, sum_c, bk.sum_ref, f0, ntot)).amax(dim=(0, 1))
    n_upd = int((block_max > st.const).sum())
    b2 = bound({"f64": 15 * o * c * i_n},
               (2 * 4 + 2 * 8) * o * c * i_n + 4 * o * c + 4 * i_n + 2 * 2 * 8 * i_n
               + n_upd * (4 + 4 + 2 * 4 + 4 * 4 + 2 * 8))
    say(f"[glue] G2's timed calls update the tuple of {n_upd} of {i_n} images")
    for key, (a, b_), bd in (("G1", t["G1"], b1), ("G2", t["G2"], b2)):
        say(f"[glue] {key} production-block time: kernel {a:.4f} ms, plain {b_:.4f} ms (the "
            f"card's own time); bound {bd[0]:.5f} ms ({bd[1]}-bound)")
    none = dict(library_ms=None)  # no single PyTorch call computes G1 or G2
    return {
        "G1": dict(name="block_constants", route="cuda",
                   source="bioem_tpu_torch/csrc/posterior_glue.cu",
                   replaces="bioem_tpu/core/engine.py:526-540,553-560,606 (XLA-fused; no Pallas kernel)",
                   max_abs_err=err1, ms=t["G1"][0], plain_ms=t["G1"][1],
                   bound_ms=b1[0], bound_by=b1[1], **none),
        "G2": dict(name="merge_block", route="cuda",
                   source="bioem_tpu_torch/csrc/posterior_glue.cu",
                   replaces="bioem_tpu/core/engine.py:580,606-610 (XLA-fused; no Pallas kernel)",
                   max_abs_err=err2, ms=t["G2"][0], plain_ms=t["G2"][1],
                   bound_ms=b2[0], bound_by=b2[1], **none),
        "G3": glue_g3(torch, eng),
        "G4": glue_g4(torch),
    }


@contextlib.contextmanager
def _environ(env: dict):
    """``env`` set in os.environ, the previous values restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _in_dir(work: str):
    old = os.getcwd()
    os.chdir(work)
    try:
        yield work
    finally:
        os.chdir(old)


@contextlib.contextmanager
def _in_case(case: str, env: dict):
    """A temporary copy of golden case ``case`` as the working directory,
    with ``env`` set; both undone on exit."""
    sys.path.insert(0, HERE)
    from tests.test_golden import DATA

    with tempfile.TemporaryDirectory() as work, _environ(env):
        shutil.copytree(os.path.join(DATA, case), work, dirs_exist_ok=True)
        with _in_dir(work):
            yield work


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


def check_against_plain(name, res, res_p, planted, orients, same_rotation=False) -> None:
    """Argmax tuples equal to the plain branch's on every image, finite
    logP, and the planted orientation recovered on ≥ 90 % of the images.
    With ``same_rotation`` a best orientation that names another grid point
    of the same rotation (q and −q: bit-equal matrices, so the same
    projection and an exact tie in logP) counts as equal, and the images
    where that happened are counted: the plain raster branch adds its
    projections with index_add_'s atomics, whose order gives q and −q
    projections that differ in the last bits and so breaks their tie
    either way, while every kernel path gives both the same bits and the
    first index wins."""
    import torch

    from bioem_tpu_torch.core.orientations import rotation_matrices

    require(bool(np.isfinite(res.log_prob).all()), f"{name}: non-finite logP")

    # q and −q are the same rotation and both lie on the quaternion grid, so
    # recovery compares rotation matrices, not grid indices.
    def rot(idx):
        return rotation_matrices(torch.as_tensor(orients.angles[idx]), orients.use_quaternions)

    fields = ("best_conv", "best_cent_x", "best_cent_y")
    rest = np.all([getattr(res, f) == getattr(res_p, f) for f in fields], axis=0)
    same_o = res.best_orient == res_p.best_orient
    twin = np.zeros_like(same_o)
    if same_rotation:
        twin = ~same_o & (rot(res.best_orient) == rot(res_p.best_orient)).all(dim=2).all(
            dim=1).numpy()
    same = rest & (same_o | twin)
    dlp = float(np.max(np.abs(res.log_prob - res_p.log_prob)))
    same_rot = (rot(res.best_orient) - rot(planted["orient"])).abs().amax(dim=(1, 2)) < 1e-5
    rec = float(same_rot.float().mean())
    rec_c = float(np.mean(res.best_conv == planted["ctf"]))
    say(f"[production] {name}: argmax tuples equal to the plain branch on "
        f"{int(same.sum())}/{len(same)} images"
        + (f" ({int((twin & rest).sum())} of them at the grid point of the same rotation, "
           "q against −q)" if same_rotation else "")
        + f"; max |ΔlogP| vs plain {dlp:.3e}; planted orientation recovered {rec:.3f}, "
          f"planted CTF {rec_c:.3f}")
    require(bool(same.all()), f"{name}: argmax tuples differ from the plain branch")
    require(rec >= 0.9, f"{name}: planted orientations not recovered")


def _run(name, problem, cfg):
    """run_bioem on the card with the launches of K1, K2, K4 and G4 it
    made."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, _ = problem
    fns = (cc_mod.fused_compare_block, pj.fourier_project_block,
           cc_mod.fused_compare_block_batched, pj.raster_project)
    before = [fn.launches for fn in fns]
    res, perf = run_bioem(p, orients, model, images, cfg, device=DEVICE)
    n = [fn.launches - b for fn, b in zip(fns, before)]
    say(f"[production] {name}: {perf['run_s']:.3f} s, "
        f"{perf['comparisons_per_s']:.4e} comparisons/s ({perf['comparisons']} "
        f"comparisons; K1 launches {n[0]}, K2 launches {n[1]}, K4 launches {n[2]}, "
        f"G4 launches {n[3]}; "
        f"config {perf['config']}; autotuning {perf['autotune_s']:.3f} s before it)")
    return res, perf, n


def _capturing_pass(problem) -> None:
    """The default kernel pass (K1, o_block 8) of a new engine split into
    its engine's set-up, the capture of its block step (a warm-up step and
    the capture) and the pass's replays, each timed to a synchronise; then
    a second pass on the same engine."""
    import torch

    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    p, orients, model, images, _ = problem
    eng, setup = timed(lambda: BioEMEngine(p, orients, model, images,
                                           RunConfig(use_kernels=True, autotune=False),
                                           device=DEVICE))
    _, capture = timed(eng._capture)
    _, first = timed(eng.run)
    _, second = timed(eng.run)
    say(f"[production] the capturing pass split: engine set-up {setup:.3f} s, capture "
        f"{capture:.3f} s, the pass's replays {first:.3f} s; a second pass {second:.3f} s")


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
    _capturing_pass(problem)
    phase_profile(problem)
    return res_p, res_k


def _profile_blocks(step, n_blocks: int) -> dict:
    """``step()`` ``n_blocks`` times, timed without and then with
    torch.profiler: wall time per block of each, the card's busy time per
    block under the profiler (the sum of its kernels' times: one stream,
    so they do not overlap), K1's and K2's time per block, the kernels
    launched per block, and (for eager steps: a replay carries no launching
    op) the glue by block-step phase (trace_step.glue_by_phase)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bioem_tpu_torch.tools.trace_step import device_kernels, glue_by_phase

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
               k1_ms=by("compare_fused_"), k2_ms=by("project_kernel"), launches=count(""),
               k2_launches=count("project_kernel"), glue=glue_by_phase(prof, n_blocks))
    out["other_ms"] = busy - out["k1_ms"] - out["k2_ms"]
    out["other_launches"] = out["launches"] - count("compare_fused_") - count("project_kernel")
    return out


def _profile_pass(problem, n_blocks: int, warm: int, cfg=None) -> tuple:
    """({"eager": ..., "replayed": ...} of :func:`_profile_blocks`, o_block)
    of the kernel pass under ``cfg`` (default: the default kernel pass), on
    a new engine."""
    from torch.profiler import ProfilerActivity, profile

    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    p, orients, model, images, _ = problem
    eng = BioEMEngine(p, orients, model, images,
                      cfg or RunConfig(use_kernels=True, autotune=False), device=DEVICE)
    state = eng.initial_state()
    blk = iter(range(warm + 2 * n_blocks))  # warm-up, then timed and profiled runs

    def eager():
        b = next(blk)
        eng._block_step(state, eng.banks, eng.ang_blocks[b], b * eng.o_block,
                        eng.mask_blocks[b])

    # This script's first profiler session recorded 6.0 of an eager block's
    # 7 kernels on an H100 (a fresh process with nothing run before records
    # all 7; the cause is not known), the sessions after it all 7: the
    # warm-up runs under a throwaway session.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(warm):
            eager()
    out = {"eager": _profile_blocks(eager, n_blocks)}
    eng._graph_load(eng.initial_state(), 0)
    for _ in range(warm):
        eng._replay()
    out["replayed"] = _profile_blocks(eng._replay, n_blocks)
    return out, eng.o_block


def phase_profile(problem, n_blocks: int = 32, warm: int = 4) -> dict:
    """The default kernel pass (K1, o_block 8), ``n_blocks`` blocks timed
    and ``n_blocks`` more profiled after ``warm``, two ways: as the eager
    loop of block steps (a host dispatch per kernel) and as the pass runs
    it, one replay of the captured block step per block. For each: wall
    time per block without and under torch.profiler, the card's busy time
    per block and its share of the profiled wall time, K1's and K2's time
    per block, the kernels launched per block, and the eager loop's glue
    by phase. The replayed block must launch at most 15 kernels, the
    projection phase at most 2 (G3 and K2) and the constants phase 1 (G1).
    Where the profiler attributes no kernel time to the graph's replays,
    the replayed loop's wall time stands against the eager profile's busy
    time, and the line says so."""
    out, o_block = _profile_pass(problem, n_blocks, warm)
    for name, r in out.items():
        say(f"[profile] default kernel pass (K1, o_block {o_block}), {n_blocks} blocks, "
            f"{name}: wall {r['wall_ms']:.3f} ms per block ({r['wall_prof_ms']:.3f} "
            f"under torch.profiler), card busy {r['busy_ms']:.3f} ms per block "
            f"({100 * r['share']:.1f} %), K1 (prologue and main kernel) {r['k1_ms']:.3f} ms, "
            f"K2 {r['k2_ms']:.3f} ms, the other {r['other_launches']:.1f} kernels "
            f"{r['other_ms']:.3f} ms; {r['launches']:.1f} kernels per block")
    e, g = out["eager"], out["replayed"]
    say("[profile] glue by phase, eager: " + "; ".join(
        f"{ph.removeprefix('bioem.')} {n:.1f} kernels {us:.1f} us"
        for ph, (n, us) in sorted(e["glue"].items())) + " per block")
    require(e["k1_ms"] > 0 and e["k2_ms"] > 0, "the profiled eager loop shows no K1 or K2 time")
    if g["busy_ms"] == 0:
        say(f"[profile] torch.profiler attributes no kernel time to the graph's replays: the "
            f"replayed wall time {g['wall_ms']:.3f} ms per block stands against the eager "
            f"loop's busy time {e['busy_ms']:.3f} ms ({100 * e['busy_ms'] / g['wall_ms']:.1f} %)")
    say(f"[profile] replayed against eager: wall {g['wall_ms']:.3f} against {e['wall_ms']:.3f} "
        f"ms per block ({e['wall_ms'] / g['wall_ms']:.2f}x)")
    const_n = e["glue"].get("bioem.constants", (0.0, 0.0))[0]
    require(const_n == 1, f"the constants phase launches {const_n:.1f} kernels per block, not 1")
    proj = e["glue"].get("bioem.projection", (0.0, 0.0))[0] + e["k2_launches"]
    say(f"[profile] the projection phase: {proj:.1f} kernels per block (G3 and K2)")
    if g["busy_ms"] > 0:
        require(g["launches"] <= 15, f"the replayed block launches {g['launches']:.1f} kernels, "
                "not ≤ 15")
    require(proj <= 2, f"the projection phase launches {proj:.1f} kernels per block, not ≤ 2")
    return out


# The raster kernel pass against the Fourier kernel pass on the production
# model: the two projections are one function, so their logP differ only by
# f32 rounding (the spectra's, then the comparison's). The limit is 4× the
# gap measured on an H100, 7.734e-4 of |logP| ≈ 7e4 (PERF.md §6); a
# projection that misplaced or mis-weighted density would move logP by
# orders more.
RASTER_VS_FOURIER = 3.1e-3


def phase_raster(problem, res_k, card: str) -> None:
    """The raster projection on the card: (a) the production problem with
    RunConfig(projection="raster") on the plain branch and the kernel
    branch (G4, then K1; replayed), argmax tuples equal (a best orientation
    at q against −q, one rotation, counting as equal: see
    :func:`check_against_plain`), finite logP, the planted parameters
    recovered, and logP against the Fourier kernel pass
    (``res_k``) within RASTER_VS_FOURIER, and the two passes timed side by
    side (:func:`_side_by_side`); (b) rank_models at MESH_DEPTH
    orientations of the production model and a continuous-radius candidate
    (every radius times 1 + 0.02·u, u uniform from the seed: 500 distinct
    radii, so the raster for both), one capture, each model equal to its
    own raster engine; (d) the replayed raster block under the profiler,
    before (the plain raster projection inside the kernel branch) and after
    (G4)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.io.model_io import Model
    from bioem_tpu_torch.ops import project_cuda as pj
    from bioem_tpu_torch.rank import rank_models
    from bioem_tpu_torch.run import run_bioem

    p, orients, model, images, planted = problem
    raster = dict(autotune=False, projection="raster")
    res_rp, _, _ = _run("raster, plain branch", problem, RunConfig(use_kernels=False, **raster))
    require(bool(np.isfinite(res_rp.log_prob).all()), "raster plain branch: non-finite logP")
    res_r, _, n = _run("raster, kernel branch (G4, K1)", problem,
                       RunConfig(use_kernels=True, **raster))
    require(n[0] > 0 and n[3] > 0 and n[1] == 0, "the raster kernel branch did not launch G4 "
            "and K1, or launched K2")
    check_against_plain("raster kernel branch (G4, K1)", res_r, res_rp, planted, orients,
                        same_rotation=True)
    gap = float(np.max(np.abs(res_r.log_prob - res_k.log_prob)))
    same = np.all([getattr(res_r, f) == getattr(res_k, f) for f in ARGMAX], axis=0)
    say(f"[raster] kernel pass (G4, K1) against the Fourier kernel pass (G3, K2, K1) on the "
        f"production model: max |ΔlogP| {gap:.3e} (limit {RASTER_VS_FOURIER:g}; "
        f"{gap / float(np.max(np.abs(res_k.log_prob))):.2e} of max |logP|), argmax tuples equal "
        f"on {int(same.sum())}/{len(same)} images")
    require(gap <= RASTER_VS_FOURIER, "the raster kernel pass strays from the Fourier kernel pass")
    _side_by_side(problem, card)

    u = np.random.default_rng(SEED).uniform(size=model.n_points)
    cand = Model(model.points, (model.radii * (1.0 + 0.02 * u)).astype(np.float32),
                 model.densities, model.norm_den)
    require(np.unique(cand.radii).size == model.n_points, "the candidate's radii are not distinct")
    models, names = [model, cand], ["production", "continuous radii"]
    cfg = RunConfig(use_kernels=True, autotune=False, debug_break=MESH_DEPTH)
    before = (pj.raster_project.launches, pj.fourier_project_block.launches)
    t0 = time.perf_counter()
    total, _per_image, perf = rank_models(p, orients, models, images, cfg, device=DEVICE)
    wall = time.perf_counter() - t0
    g4, k2 = (pj.raster_project.launches - before[0], pj.fourier_project_block.launches - before[1])
    say(f"[raster] {card}: rank_models of the production model and a continuous-radius "
        f"candidate (500 distinct radii) × {images.n} images at {MESH_DEPTH} orientations: "
        f"{wall:.3f} s, captures {perf['captures']}, G4 launches {g4}, K2 launches {k2}; "
        + ", ".join(f"{nm} lnP {t:.4f}" for nm, t in zip(names, total)))
    require(perf["captures"] == 1 and g4 > 0 and k2 == 0,
            "the mixed-radius ranking did not share one capture on G4")
    for m in (0, 1):
        own, _ = run_bioem(p, orients, models[m], images,
                           RunConfig(use_kernels=True, debug_break=MESH_DEPTH, **raster),
                           device=DEVICE)
        _held(f"raster: ranked {names[m]} vs its own raster engine", perf["results"][m], own)
    phase_raster_profile(problem)


def phase_voxel_map(card: str) -> None:
    """Step 6b of the module docstring: G4 and the census on voxel maps."""
    import torch

    from bioem_tpu_torch.tools import kernel_probe as kp

    dev = torch.device(DEVICE)
    for wide in (False, True):
        r = kp.check_raster_sparse(dev, wide)
        say(f"[voxel map] {card}: G4 on a sheet of {r['pairs']} (orientation, point) pairs whose "
            f"stencils never meet (stencil_half {r['stencil_half']}): snaps equal "
            f"{r['snaps_equal']}, weights bit-equal {r['weights_equal']}, scale max rel |Δ| "
            f"{r['scale_rel']:.2e}")
        require(r["snaps_equal"] and r["weights_equal"] and r["scale_rel"] <= 1e-6,
                "G4's weights or snaps differ from the plain version's")

    def held(c, what):
        say(f"[voxel map] {what}: {c['differ']} of {c['pairs']} pairs snap elsewhere (off ties "
            f"{c['off_tie']}), {c['compared']} rows compared, projection max |Δ| "
            f"{c['proj_rel']:.2e} of max |pixel| (within f32 reordering's bound: "
            f"{c['reorder_ok']}), scale {c['scale_rel']:.2e}, two launches bit-equal {c['bits']}")
        require(c["off_tie"] == 0 and c["bits"] and c["reorder_ok"] and c["compared"] > 0
                and c["scale_rel"] <= 1e-6, f"G4 strays from the plain version on {what}")

    def held_lattice(c, what):
        held(c, f"{what}, lattice variant")
        say(f"[voxel map] {what}, lattice variant against the generic: snaps equal "
            f"{c['snaps_equal']} ({c['in_frame']} in the frame), scales {c['scale_ulps']} ulp apart")
        require(c["snaps_equal"] and c["scale_ulps"] <= 1,
                f"G4's lattice variant strays from the generic on {what}")

    for box in (32, 48):
        held(kp.check_raster(kp.map_inputs(dev, box)), f"the {box}³ map at N = {box}")
    for box, shift in ((32, (0, 0)), (48, (2, -3)), ((33, 40, 27), (-1, 2))):
        name = "x".join(map(str, box)) if isinstance(box, tuple) else f"{box}³"
        x = kp.map_inputs(dev, box, angles=kp.lattice_angles(), shift=shift)
        held_lattice(kp.check_raster_lattice(x), f"the {name} map, shift {shift}")
    x = kp.map_inputs(dev, 224)
    for row in (0, 7):
        held(kp.check_raster(x, [row]), f"row {row} of a 224³ map block")
        torch.cuda.empty_cache()
        held_lattice(kp.check_raster_lattice(x, [row]), f"row {row} of a 224³ map block")
        torch.cuda.empty_cache()
    del x
    m = kp.raster_map_block(dev)
    for name in ("generic", "lattice"):
        v = m[name]
        say(f"[voxel map] {card}: one block of the 224³ map ({m['points']} voxels, 8 "
            f"orientations): G4 {name} {v['ms']:.3f} ms in {v['kernels']} kernel launches a call "
            f"(raster_project counted {v['calls']} calls), rfft2 {m['rfft2_ms']:.4f} ms (card "
            f"time); mean of every 64th block {np.mean(list(v['across'].values())):.3f} ms; two "
            f"launches bit-equal {v['bits']}, finite {v['finite']}, sum against norm_den "
            f"{v['sum_rel']:.2e}")
        require(v["bits"] and v["finite"] and v["sum_rel"] < 1e-4,
                f"G4's {name} variant fails on the 224³ map")
    for box, stride in ((32, 1), (224, 288)):
        c = kp.check_census(dev, box, stride)
        say(f"[voxel map] census of the {box}³ map, {c['orients']} orientations: card "
            f"{c['card']}, host {c['host']}, pairs at a snap's tie {c['ties']}")
        require(c["card"][1:] == c["host"][1:] and c["host"][0] > 0
                and abs(c["card"][0] - c["host"][0]) <= c["ties"],
                f"the card's census differs from the host's on the {box}³ map")
    kp.path_rule_times(dev, say=lambda msg: say(f"[voxel map] {msg}"))


def _side_by_side(problem, card: str) -> None:
    """The Fourier kernel pass and the raster kernel pass (both K1, o_block
    8) on the production problem, each engine captured by a first pass,
    then timed in turns Fourier, raster, raster, Fourier, Fourier, raster:
    the best of three replayed passes each, each ending in a synchronise."""
    import torch

    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    p, orients, model, images, _ = problem
    eng = {name: BioEMEngine(p, orients, model, images,
                             RunConfig(use_kernels=True, autotune=False, projection=name),
                             device=DEVICE) for name in ("fourier", "raster")}
    best = {}
    for name, e in eng.items():
        e.run()
        best[name] = float("inf")
    for name in ("fourier", "raster", "raster", "fourier", "fourier", "raster"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng[name].run()
        torch.cuda.synchronize()
        best[name] = min(best[name], time.perf_counter() - t0)
    say(f"[raster] {card}: side by side, best of 3 replayed passes in turns: Fourier kernel "
        f"pass (G3, K2, K1) {best['fourier']:.4f} s, raster kernel pass (G4, K1) "
        f"{best['raster']:.4f} s")


def phase_raster_profile(problem, n_blocks: int = 32, warm: int = 4) -> None:
    """The raster kernel pass (K1, o_block 8), eager and replayed under the
    profiler as :func:`phase_profile` profiles the default pass, in two
    configurations: before, the plain raster projection inside the kernel
    branch (kernel_projection off: the rotation matrices, ~25 elementwise
    kernels of stencil weights, torch.sum and index_add_), and after, G4;
    then rfft2 and the two
    copies of its real and imaginary parts, in both. Kernels per block,
    wall and busy ms per block, and the projection phase's kernels and µs
    (the eager loop's glue by phase, G4 included). The replayed block must
    launch fewer kernels after than before."""
    from bioem_tpu_torch.config import RunConfig

    res = {}
    for when, kp in (("before (plain raster projection)", False), ("after (G4)", True)):
        res[when], o_block = _profile_pass(problem, n_blocks, warm, RunConfig(
            use_kernels=True, autotune=False, projection="raster", kernel_projection=kp))
        proj = res[when]["eager"]["glue"].get("bioem.projection", (0.0, 0.0))
        for name, r in res[when].items():
            say(f"[raster profile] raster kernel pass (K1, o_block {o_block}), {n_blocks} blocks, "
                f"{name}, {when}: wall {r['wall_ms']:.3f} ms per block ({r['wall_prof_ms']:.3f} "
                f"under torch.profiler), card busy {r['busy_ms']:.3f} ms per block "
                f"({100 * r['share']:.1f} %), K1 {r['k1_ms']:.3f} ms, the other "
                f"{r['other_launches']:.1f} kernels {r['other_ms']:.3f} ms; "
                f"{r['launches']:.1f} kernels per block")
        say(f"[raster profile] glue by phase, eager, {when}: " + "; ".join(
            f"{ph.removeprefix('bioem.')} {k:.1f} kernels {us:.1f} us"
            for ph, (k, us) in sorted(res[when]["eager"]["glue"].items())) + " per block; "
            f"the projection phase {proj[0]:.1f} kernels {proj[1]:.1f} us")
    b, a = (res[w]["replayed"] for w in res)
    say(f"[raster profile] replayed raster block, before against after: {b['launches']:.1f} "
        f"against {a['launches']:.1f} kernels, wall {b['wall_ms']:.3f} against "
        f"{a['wall_ms']:.3f} ms, busy {b['busy_ms']:.3f} against {a['busy_ms']:.3f} ms")
    require(res["after (G4)"]["eager"]["k1_ms"] > 0, "the profiled raster pass shows no K1 time")
    if a["busy_ms"] > 0:
        require(a["launches"] < b["launches"],
                "the replayed raster block launches no fewer kernels with G4")


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
    from bioem_tpu_torch.ops import posterior_cuda as glue
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
                                   "K4": cc_mod.fused_compare_block_batched.launches,
                                   "G1": glue.block_constants.launches,
                                   "G2": glue.merge_block.launches,
                                   "G3": pj.project_prologue.launches}}),
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
    out = {k: sum(i["launches"][k] for i in info)
           for k in ("K1", "K2", "K3", "K4", "G1", "G2", "G3")}
    say("[multiprocess] the workers' launches: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    require(all(out[k] > 0 for k in ("K1", "K2", "G1", "G2", "G3")),
            "the workers did not launch K1, K2, G1, G2 and G3")
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
    o_block 8) and on the raster kernel pass (``--projection raster``): K1
    and K2, or K1 and G4, named in the trace, its rows with ``other``
    within 5 % of the profiler's device time."""
    from bioem_tpu_torch.tools import profile_block, trace_step

    for projection, kernels in (("auto", ("compare_fused_kernel", "project_kernel")),
                                ("raster", ("compare_fused_kernel", "raster_projection_kernel"))):
        tag = "" if projection == "auto" else ", raster"
        out = profile_block.profile(profile_block.engine_for(problem, device=DEVICE,
                                                             projection=projection))
        profile_block.report(out, say=lambda m: say(f"[profile_block{tag}] {card}: {m}"))
        tr = trace_step.trace(profile_block.engine_for(problem, device=DEVICE,
                                                       projection=projection), n_blocks=n_blocks)
        trace_step.report(tr, say=lambda m: say(f"[trace_step{tag}] {m}"))
        names = " ".join(r[0] for r in tr["rows"])
        require(tr["fallback"] is None, tr["fallback"] or "")
        require(all(k in names for k in kernels), f"the trace does not name {', '.join(kernels)}")
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


# ---------------------------------------------------------------------------
# The benchmark harness, the reference's production grid, the C2 check
# ---------------------------------------------------------------------------

# Every key of the harness's JSON line on the card (tools/bench.py).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_kind",
              "max_abs_dlogp_vs_reference", "accuracy_cases", "max_abs_dlogp_vs_reference_n224",
              "problem", "comparison", "config", "autotune_s", "comparisons", "seconds",
              "device_kind", "useful_f32_flops_per_comparison", "achieved_useful_tflops",
              "bound_s", "bound_by", "roofline_pct", "card")


def phase_bench(card: str, problem: str) -> dict:
    """``python -m bioem_tpu_torch.tools.bench --problem <problem>`` in this
    process, tuned from an empty autotune cache: one JSON line with every
    key, the card named; bench.py's own problem runs the hybrid (its raw
    noise closes the f32 gate), the planted one K1 or K4, launched, at or
    below 100 % of its bound."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.tools import bench

    with tempfile.TemporaryDirectory() as cache, _environ(
            {"BIOEM_TPU_AUTOTUNE_CACHE": os.path.join(cache, "autotune.json")}):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--problem", problem])
    lines = buf.getvalue().strip().splitlines()
    say(f"[bench] {card}: {lines[-1]}  ({time.perf_counter() - t0:.1f} s)")
    rec = json.loads(lines[-1])
    require(rc == 0 and len(lines) == 1, f"bench --problem {problem}: rc {rc}, "
            f"{len(lines)} lines of output")
    missing = [k for k in BENCH_KEYS if k not in rec]
    require(not missing, f"bench --problem {problem}: keys missing {missing}")
    require(rec["card"] == card and rec["problem"] == problem and rec["value"] > 0,
            f"bench --problem {problem}: card, problem or value wrong")
    require(0 < rec["roofline_pct"] <= 100, f"bench: roofline share {rec['roofline_pct']}")
    if problem == "bench":
        require(rec["comparison"] == "hybrid", f"bench's problem ran {rec['comparison']}")
    else:
        fn = {"K1": cc_mod.fused_compare_block,
              "K4": cc_mod.fused_compare_block_batched}.get(rec["comparison"])
        require(fn is not None and fn.launches > 0,
                f"the planted problem ran {rec['comparison']} without launching it")
    return rec


# K1's tiling at the reference grid's block (D = 81, M = 224, fold 1), as
# fused_compare_block.last_plan reports it: two warpgroups, K chunks of eight
# steps, the lattice in one chunk of 88 rows, so that each formed p is read
# by its three 32-row parts.
REF_PLAN = (2, 8, 3)


def kernel_row_d81(torch) -> dict:
    """K1 and K3 at the reference grid's block (O = 8, C = 32, I = 64,
    N = 224, D = 81 at stride 1, M = 224) against their plain versions,
    each launched with plan :data:`REF_PLAN`; K1 timed beside its plain
    version and its bound. Returns K1's row for the kernels line."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.tools.kernel_probe import time_ms
    from bioem_tpu_torch.tools.problem import REFERENCE_GRID, build_problem, compare_bound

    p, orients, model, images, _ = build_problem(**REFERENCE_GRID)
    eng = BioEMEngine(p, orients, model, images, RunConfig(use_kernels=True, autotune=False),
                      device=DEVICE)
    x = _block_inputs(eng)
    bk = eng.banks
    args = (x["pr"], x["pi"], bk.ctf_re, bk.ctf_im, bk.img_re, bk.img_im,
            x["wx_re"], x["wx_im"], bk.wy_re, bk.wy_im, x["a_u"], x["b_u"])
    o, c, i_n, n, f = eng.o_block, eng.n_ctf, bk.img_re.shape[0], p.n_pixels, p.n_fft_1d
    d, nf = eng.disp.shape[0], eng.n_fold
    m = n // nf
    say(f"[kernels] reference grid block: O={o} C={c} I={i_n} N={n} F={f} D={d} n_fold={nf}; "
        f"k1_plan {cc_mod.k1_plan(d, m, f, nf)}")
    err = check_compare(torch, "K1 fused_compare_block D=81", args, x["a_coef"], nf)
    require(cc_mod.fused_compare_block.last_plan == REF_PLAN == cc_mod.k1_last_plan(d, m, f, nf),
            f"K1 at D=81 launched with plan {cc_mod.fused_compare_block.last_plan}")
    conv_re = (x["pr"][:, None] * bk.ctf_re[None] + x["pi"][:, None] * bk.ctf_im[None]).reshape(o * c, n, f)
    conv_im = (x["pi"][:, None] * bk.ctf_re[None] - x["pr"][:, None] * bk.ctf_im[None]).reshape(o * c, n, f)
    check_cc(torch, "K3 fused_displacement_cc D=81", conv_re, conv_im, bk.img_re, bk.img_im,
             x["wx_re"], x["wx_im"], bk.wy_re, bk.wy_im, nf, 2)
    require(cc_mod.fused_displacement_cc.last_plan == REF_PLAN,
            f"K3 at D=81 launched with plan {cc_mod.fused_displacement_cc.last_plan}")
    del conv_re, conv_im
    ms = time_ms(lambda: cc_mod.fused_compare_block(*args, a_coef=x["a_coef"], n_fold=nf))
    plain_ms = time_ms(lambda: cc_mod.fused_compare_block_plain(*args, a_coef=x["a_coef"],
                                                                n_fold=nf), 3)
    b = compare_bound(o, c, i_n, n, f, d, m, nf, tensor_cores=True)
    say(f"[kernels] K1 D=81 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
        f"{b[0]:.4f} ms ({b[1]}-bound), {100 * b[0] / ms:.1f} % of it")
    return dict(name="fused_compare_block (D=81)", route="cuda",
                source="bioem_tpu_torch/csrc/compare_fused.cu",
                replaces="bioem_tpu/ops/compare_pallas.py:301", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)


def _grid_cli(prob, env: dict | None = None):
    """``prob`` (a problem at REFERENCE_GRID or WIDE_GRID, or a cut of one)
    written as the CLI reads it and run through the port's CLI under
    ``env``: (the main loop's seconds, the CLI's wall seconds, logP, the
    Maximizing Param rows)."""
    import re

    from bioem_tpu_torch.cli import main as cli_main
    from bioem_tpu_torch.tools.golden_error_budget import parse_golden, parse_maximizing
    from bioem_tpu_torch.tools.problem import write_reference_grid

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as work:
        argv = write_reference_grid(work, prob)
        t0 = time.perf_counter()
        with _in_dir(work), _environ({"BIOEM_DEBUG_OUTPUT": "1", **(env or {})}), \
                contextlib.redirect_stdout(buf):
            rc = cli_main([*argv, "--OutputFile", "out"])
            wall = time.perf_counter() - t0
            lp, best = parse_golden("out"), parse_maximizing("out")
    found = re.search(r"Main loop: ([0-9.]+)s", buf.getvalue())
    require(rc == 0 and found is not None, f"the grid's CLI returned {rc}")
    return float(found.group(1)), wall, lp, best


def _grid_recovered(prob, best) -> tuple:
    """Shares of the images whose Maximizing Param row names the planted
    rotation (the written quaternion, 4 decimals) and the planted CTF (its
    defocus and B-env)."""
    from bioem_tpu_torch.params import make_ctf_grid

    p, orients, planted = prob[0], prob[1], prob[4]
    grid = make_ctf_grid(p)
    q = orients.angles[planted["orient"]].astype(np.float64)
    rec_o = float(np.mean(np.abs(np.sum(best[:, 1:5] * q, axis=1))
                          / np.linalg.norm(best[:, 1:5], axis=1) > 1 - 1e-4))
    defocus = grid.phase / 2.0 / np.pi / p.electron_wavelength * 1e-4
    c = planted["ctf"]
    rec_c = float(np.mean((np.abs(best[:, 6] - defocus[c]) < 1e-4)
                          & (np.abs(best[:, 7] - grid.env[c]) < 1e-4)))
    return rec_o, rec_c


def phase_reference_grid(card: str) -> None:
    """The reference's production grid through the port's CLI: 4608
    super-Fibonacci quaternions (--ReadOrientation) × 32 CTFs × 64 planted,
    normalised images (an MRC stack, --ReadMRC) at D = 81, stride 1. K1
    must run at plan :data:`REF_PLAN` and K4 never; every logP finite; the
    planted orientation and CTF recovered on ≥ 90 % of the images. Then a
    cut of the grid (each planted orientation and its nearest neighbour,
    all 32 CTFs, the 64 images) on the plain branch, K1 and the hybrid (K3
    on K1's tiling): argmax tuples equal to the plain branch's."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.params import make_ctf_grid
    from bioem_tpu_torch.tools.golden_error_budget import run_configs
    from bioem_tpu_torch.tools.problem import REFERENCE_GRID, build_problem, orientation_cut

    prob = build_problem(**REFERENCE_GRID)
    p, orients, _model, images, _planted = prob
    k1, k4 = cc_mod.fused_compare_block, cc_mod.fused_compare_block_batched
    before = (k1.launches, k4.launches)
    k1.last_plan = None
    run_s, wall, lp, best = _grid_cli(prob)
    n1, n4 = k1.launches - before[0], k4.launches - before[1]
    n_ctf = make_ctf_grid(p).n
    comparisons = orients.n * n_ctf * images.maps.shape[0]
    rec_o, rec_c = _grid_recovered(prob, best)
    say(f"[reference grid] {card}: {orients.n} orientations × {n_ctf} CTFs × "
        f"{images.maps.shape[0]} images at N={p.n_pixels}, D={p.nx_disp} (stride "
        f"{p.grid_space_center}) through the CLI: pass {run_s:.3f} s, {comparisons / run_s:.4e} "
        f"comparisons/s ({comparisons} comparisons; CLI wall {wall:.1f} s); K1 launches {n1} "
        f"at plan {k1.last_plan}, K4 launches {n4}; logP finite {bool(np.isfinite(lp).all())}; "
        f"planted orientation recovered {rec_o:.3f}, planted CTF {rec_c:.3f}")
    require(n1 > 0 and k1.last_plan == REF_PLAN and n4 == 0,
            f"the reference grid did not run K1 at plan {REF_PLAN} alone")
    require(len(lp) == images.maps.shape[0] and bool(np.isfinite(lp).all()),
            "the reference grid's logP are not all finite")
    require(rec_o >= 0.9 and rec_c >= 0.9, "the reference grid lost the planted parameters")
    cut = orientation_cut(prob, 2)
    t0 = time.perf_counter()
    rows = run_configs(cut, ("plain", "K1", "hybrid"), DEVICE)
    plain = rows["plain"]["results"]
    for name, r in rows.items():
        res = r["results"]
        same = np.all([getattr(res, f) == getattr(plain, f) for f in ARGMAX], axis=0)
        say(f"[reference grid] cut of {cut[1].n} orientations × {n_ctf} CTFs × "
            f"{images.maps.shape[0]} images: {name} (ran {r['ran']}) argmax tuples equal to "
            f"the plain branch on {int(same.sum())}/{len(same)} images; max |ΔlogP| vs plain "
            f"{float(np.max(np.abs(res.log_prob - plain.log_prob))):.3e}")
        require(r["ran"] == name and bool(same.all()),
                f"reference grid cut: {name} ran {r['ran']} or its argmax differs from plain")
    require(cc_mod.fused_displacement_cc.last_plan == REF_PLAN,
            f"K3 did not run at plan {REF_PLAN}")
    say(f"[reference grid] the cut's three passes {time.perf_counter() - t0:.1f} s")


def kernel_row_wide(torch) -> dict:
    """K1 and K3 on lattices the earlier K1 refused or ran on two
    warpgroups, on random inputs (kernel_probe.block_inputs, stride 1):
    N = 224, D = 121 (±60; O = 8, C = 8, I = 64, two row chunks of 64) and
    N = 512, D = 81 (±40; O = 4, C = 4, I = 32, one of 88), each launched
    with k1_plan's two-warpgroup wide tiling and held to its plain version at the
    production tolerances (check_compare, check_cc); K1 at D = 121 timed
    beside its plain version and its bound. Returns that row for the
    kernels line.

    se at N = 512: se carries v's absolute f32 error, |a_coef|·δcc, and
    a_coef grows as N²; the plain version itself lies ~1.6e-3 from the f64
    log-sum-exp there (the [kernels] line's "plain"), so the kernel is held
    to 1.5e-4 scaled by a_coef against N = 224's (7.8e-4), and, as
    everywhere, to lie no farther from f64 than 4× the plain version."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.tools.kernel_probe import block_inputs, time_ms
    from bioem_tpu_torch.tools.problem import compare_bound

    row = None
    for o, c, i_n, n, d in ((8, 8, 64, 224, 121), (4, 4, 32, 512, 81)):
        args, a_coef, nf = block_inputs(DEVICE, o, c, i_n, n, d, 1, seed=SEED)
        f, m = n // 2 + 1, n // nf
        plan = cc_mod.k1_plan(d, m, f, nf)
        say(f"[kernels] wide lattice block: O={o} C={c} I={i_n} N={n} F={f} D={d} "
            f"n_fold={nf}; k1_plan {plan}")
        se_rtol = 1.5e-4 * a_coef / ((3.0 - 224 * 224) / 2)
        err = check_compare(torch, f"K1 fused_compare_block N={n} D={d}", args, a_coef, nf,
                            se_rtol=se_rtol)
        require(plan[0] == 2 and cc_mod.fused_compare_block.last_plan
                == cc_mod.k1_last_plan(d, m, f, nf),
                f"K1 at N={n} D={d} launched with plan {cc_mod.fused_compare_block.last_plan}")
        conv_re = (args[0][:, None] * args[2][None] + args[1][:, None] * args[3][None]).reshape(o * c, n, f)
        conv_im = (args[1][:, None] * args[2][None] - args[0][:, None] * args[3][None]).reshape(o * c, n, f)
        check_cc(torch, f"K3 fused_displacement_cc N={n} D={d}", conv_re, conv_im, *args[4:10],
                 nf, 2)
        require(cc_mod.fused_displacement_cc.last_plan[:2] == plan[:2],
                f"K3 at N={n} D={d} launched with plan {cc_mod.fused_displacement_cc.last_plan}")
        del conv_re, conv_im
        if d != 121:
            continue
        ms = time_ms(lambda: cc_mod.fused_compare_block(*args, a_coef=a_coef, n_fold=nf))
        plain_ms = time_ms(lambda: cc_mod.fused_compare_block_plain(*args, a_coef=a_coef,
                                                                    n_fold=nf), 3)
        b = compare_bound(o, c, i_n, n, f, d, m, nf, tensor_cores=True)
        say(f"[kernels] K1 N={n} D={d} time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
            f"bound {b[0]:.4f} ms ({b[1]}-bound), {100 * b[0] / ms:.1f} % of it")
        row = dict(name="fused_compare_block (D=121)", route="cuda",
                   source="bioem_tpu_torch/csrc/compare_fused.cu",
                   replaces="bioem_tpu/ops/compare_pallas.py:301", max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], library_ms=None)
    return row


def phase_wide_grid(card: str) -> None:
    """The reference grid searching ±60 pixels (problem.WIDE_GRID: D = 121
    at stride 1, which the earlier K1 refused), cut to each planted
    orientation and its nearest neighbour (orientation_cut: ≤ 128
    orientations) × 32 CTFs × 64 planted images, through the port's CLI on
    the kernel branch (K1 on two warpgroups, K4 never) and on the plain
    branch (BIOEM_TPU_PALLAS=0): the Maximizing Param rows (argmax tuples)
    equal, every logP finite, the planted orientation and CTF recovered on
    ≥ 90 % of the images. Then the C2 check on a cut of 2 images × 4
    orientations × 32 CTFs: K1 and the hybrid (K3) no farther from the
    all-f64 oracle than max(5e-6, the plain branch's gap), argmax tuples
    equal to the plain branch's."""
    from bioem_tpu_torch.ops import compare_cuda as cc_mod
    from bioem_tpu_torch.params import make_ctf_grid
    from bioem_tpu_torch.tools.problem import WIDE_GRID, build_problem, orientation_cut

    t0 = time.perf_counter()
    cut = orientation_cut(build_problem(**WIDE_GRID), 2)
    p, orients, images = cut[0], cut[1], cut[3]
    k1, k4 = cc_mod.fused_compare_block, cc_mod.fused_compare_block_batched
    plan = cc_mod.k1_plan(p.nx_disp, p.n_pixels, p.n_fft_1d, 1)
    before = (k1.launches, k4.launches)
    k1.last_plan = None
    run_k, wall_k, lp_k, best_k = _grid_cli(cut)
    n1, n4 = k1.launches - before[0], k4.launches - before[1]
    run_p, wall_p, lp_p, best_p = _grid_cli(cut, {"BIOEM_TPU_PALLAS": "0"})
    same = np.all(best_k[:, 1:] == best_p[:, 1:], axis=1)
    rec_o, rec_c = _grid_recovered(cut, best_k)
    say(f"[wide grid] {card}: {orients.n} orientations × {make_ctf_grid(p).n} CTFs × "
        f"{images.maps.shape[0]} "
        f"images at N={p.n_pixels}, D={p.nx_disp} (stride {p.grid_space_center}) through the "
        f"CLI: kernel branch pass {run_k:.3f} s (wall {wall_k:.1f} s; K1 launches {n1} at plan "
        f"{k1.last_plan}, K4 launches {n4}), plain branch pass {run_p:.3f} s (wall "
        f"{wall_p:.1f} s); argmax tuples equal on {int(same.sum())}/{len(same)} images; max "
        f"|ΔlogP| {float(np.max(np.abs(lp_k - lp_p))):.3e}; planted orientation recovered "
        f"{rec_o:.3f}, planted CTF {rec_c:.3f}")
    require(p.nx_disp == 121 and plan[0] == 2, f"the wide grid's K1 plan is {plan}")
    require(n1 > 0 and (k1.last_plan or ())[:2] == plan[:2] and n4 == 0,
            f"the wide grid did not run K1 at plan {plan[:2]} alone")
    require(bool(same.all()), "the wide grid's argmax tuples differ from the plain branch's")
    require(bool(np.isfinite(lp_k).all() and np.isfinite(lp_p).all()),
            "the wide grid's logP are not all finite")
    require(rec_o >= 0.9 and rec_c >= 0.9, "the wide grid lost the planted parameters")
    _c2_cut(card, "wide grid", orientation_cut(build_problem(n_img=2, **WIDE_GRID), 2),
            ("plain", "K1", "hybrid"))
    require(cc_mod.fused_displacement_cc.last_plan[:2] == plan[:2],
            f"K3 did not run at plan {plan[:2]}")
    say(f"[wide grid] {time.perf_counter() - t0:.1f} s")


C2_ATOL = 5e-6  # the JAX suite's engine–oracle limit at N = 224


def _c2_cut(card: str, label: str, cut, configs, k1_vs_plain_full=None) -> None:
    """One C2 cut: each of ``configs`` (the plain branch first) on the card
    against the all-f64 oracle on the host (golden_error_budget.cut_gaps).
    Fault C2: a kernel configuration farther from the oracle than
    max(5e-6, the plain branch's gap); every configuration must also keep
    the plain branch's argmax tuples."""
    from bioem_tpu_torch.tools.golden_error_budget import cut_gaps

    t0 = time.perf_counter()
    _lp, rows = cut_gaps(cut, configs, DEVICE)
    plain = rows["plain"]
    limit = max(C2_ATOL, plain["engine_vs_oracle"])
    say(f"[c2] {card}: {label} cut, N={cut[0].n_pixels} D={cut[0].nx_disp}, {cut[1].n} "
        f"orientations × {cut[3].maps.shape[0]} images, oracle and {len(rows)} passes "
        f"{time.perf_counter() - t0:.1f} s; limit max(5e-6, plain's gap) = {limit:.3e}")
    for name, r in rows.items():
        res = r["results"]
        dp = float(np.max(np.abs(res.log_prob - plain["results"].log_prob)))
        same = all(np.array_equal(getattr(res, f), getattr(plain["results"], f))
                   for f in ARGMAX)
        say(f"[c2] {label}: {name} (ran {r['ran']}): max |logP − oracle| "
            f"{r['engine_vs_oracle']:.4e}, vs plain {dp:.4e}"
            + (f" (the full production pass's K1 vs plain: {k1_vs_plain_full:.4e})"
               if name == "K1" and k1_vs_plain_full is not None else ""))
        require(r["ran"] == name and same, f"c2 {label}: {name} ran {r['ran']} or its "
                f"argmax differs from the plain branch")
        require(r["engine_vs_oracle"] <= limit, f"fault C2: {label} {name} lies "
                f"{r['engine_vs_oracle']:.4e} from the oracle, beyond {limit:.4e}")
    if plain["engine_vs_oracle"] > C2_ATOL:
        say(f"[c2] {label}: the plain branch itself lies above 5e-6 from the oracle "
            f"(the JAX package's plain path has the same arithmetic): a question for "
            f"the reference, not a port fault")


def phase_c2(card: str, k1_vs_plain_full: float) -> None:
    """The C2 check: the production shape cut to 4 planted images × 16
    orientations (each planted one and its nearest neighbours) × 8 CTFs
    (N = 224, D = 21 at stride 2), and the reference grid cut to 2 images
    × 4 orientations × 32 CTFs (D = 81, stride 1), each on every kernel
    configuration it has and the plain branch on the card (:func:`_c2_cut`)."""
    from bioem_tpu_torch.tools.problem import REFERENCE_GRID, build_problem, orientation_cut

    _c2_cut(card, "production", orientation_cut(build_problem(n_img=4), 4),
            ("plain", "K1", "K4", "hybrid"), k1_vs_plain_full)
    _c2_cut(card, "reference grid",
            orientation_cut(build_problem(n_img=2, **REFERENCE_GRID), 2),
            ("plain", "K1", "hybrid"))


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
        from bioem_tpu_torch.ops import posterior_cuda as glue
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
        rows.update(phase_glue(torch, eng))
        del eng

        counters = {"K1": cc_mod.fused_compare_block, "K2": pj.fourier_project_block,
                    "K3": cc_mod.fused_displacement_cc,
                    "K4": cc_mod.fused_compare_block_batched,
                    "G1": glue.block_constants, "G2": glue.merge_block,
                    "G3": pj.project_prologue, "G4": pj.raster_project,
                    "census": pj.bounds_census}

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

        res_p, res_k = main_path("goldens + production K1", goldens_and_k1,
                                 ("K1", "K2", "K3", "G1", "G2", "G3", "G4"))
        main_path("raster", lambda: phase_raster(problem, res_k, card),
                  ("K1", "G1", "G2", "G4"))
        main_path("voxel map", lambda: phase_voxel_map(card), ("G4", "census"))
        main_path("production K4 + autotuned + checkpoint",
                  lambda: phase_tuned(problem, res_p, res_k, rows["K4"]["tile"]),
                  ("K2", "K4", "G1", "G2", "G3"))
        main_path("streaming", lambda: phase_streaming(problem, res_k, card),
                  ("K1", "K2", "G1", "G2", "G3"))
        main_path("ranking", lambda: phase_ranking(problem, card), ("K1", "K2", "G1", "G2", "G3"))
        ref_2x2 = main_path("mesh", lambda: phase_mesh(problem, res_k, card),
                            ("K1", "K2", "G1", "G2", "G3"))
        # the two worker processes' counters start at 0 with the processes
        for k, n in phase_multiprocess(ref_2x2, problem[3].maps, card).items():
            rows[k]["launches"] = rows[k].get("launches", 0) + n
        phase_native(card)
        main_path("refinement", lambda: phase_refinement(problem, card), ("K2", "G1", "G2", "G3"))
        from bioem_tpu_torch.ops import probe_cuda

        counters.update(P1=probe_cuda.f32_product, P2=probe_cuda.product_sum,
                        P3=probe_cuda.body_ablation)
        probe_rows = main_path("probe tool", phase_probes, ("P1", "P2", "P3"))
        for k, r in probe_rows.items():
            rows[k] = {**r, "launches": counters[k].launches}
        phase_bestmap()
        main_path("DEBUG_PROB", phase_debug_prob, ("K3", "G3"))
        main_path("accuracy", lambda: phase_accuracy(card),
                  ("K1", "K3", "K4", "G1", "G2", "G3", "G4"))
        main_path("examples", lambda: phase_examples(card), ("K2", "K3", "G3"))
        main_path("profile tools", lambda: phase_profile_tools(problem, card),
                  ("K1", "K2", "G1", "G2", "G3", "G4"))
        main_path("scale", lambda: phase_scale(card), ("K1", "K2", "G1", "G2", "G3"))
        main_path("stream cut", lambda: phase_stream_cut(card), ("K1", "K2", "G1", "G2", "G3"))
        main_path("rank, mesh, pipeline, noise", lambda: phase_small_tools(problem, card),
                  ("K1", "K2", "K3", "G1", "G2", "G3"))
        main_path("bench harness, bench.py's problem", lambda: phase_bench(card, "bench"),
                  ("K2", "K3", "G1", "G2", "G3"))
        main_path("bench harness, planted problem", lambda: phase_bench(card, "planted"),
                  ("K2", "G1", "G2", "G3"))
        rows["K1_D81"] = kernel_row_d81(torch)
        rows["K1_D121"] = kernel_row_wide(torch)
        main_path("reference grid", lambda: phase_reference_grid(card),
                  ("K1", "K2", "K3", "G1", "G2", "G3"))
        rows["K1_D81"]["launches"] = counters["K1"].launches
        main_path("wide grid", lambda: phase_wide_grid(card), ("K1", "K2", "K3", "G1", "G2", "G3"))
        rows["K1_D121"]["launches"] = counters["K1"].launches
        k1_vs_plain = float(np.max(np.abs(res_k.log_prob - res_p.log_prob)))
        main_path("C2 check", lambda: phase_c2(card, k1_vs_plain),
                  ("K1", "K2", "K3", "K4", "G1", "G2", "G3"))
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
