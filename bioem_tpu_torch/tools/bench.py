"""Benchmark: image×orientation×ctf comparisons/s per card against a CPU
proxy of the reference.

The port's counterpart of the JAX package's ``bench.py``, function by
function. One "comparison" is one (image, orientation, ctf) posterior
contribution integrated over the full displacement grid (BASELINE.md).
The engine runs through the port's normal entry points
(``run.maybe_autotune``, ``run.make_engine``); the baseline is a
vectorised NumPy implementation of the reference algorithm (full-map c2r
FFT cross-correlation and the per-lattice-point double-precision
log-posterior), timed live on this host and scaled by its core count (the
reference parallelises over images with OpenMP).

Two problems (``--problem``):

* ``bench`` (default): bench.py's own problem, with its env knobs and
  defaults (``BENCH_NPIX``, ``BENCH_NIMG``, ``BENCH_QUATGRID``,
  ``BENCH_REPEATS``, ``BENCH_BASELINE_SAMPLE``). Its images are raw N(0, 1)
  noise, never normalised; some close the engine's f32 gate
  (``core.engine.f32_corr_gate``), so the kernel branch runs the hybrid:
  the cc-lattice kernel (K3) and the f64 log-sum-exp.
* ``planted``: ``tools/problem.build_problem`` at the same size knobs (one
  planted projection per image, normalised), where K1 or K4 runs.

Usage (the card, or the CPU with ``--device cpu`` or
``BIOEM_TPU_FORCE_CPU=1``):

    python -m bioem_tpu_torch.tools.bench [--problem bench|planted] [--device cpu]

Prints one JSON line: bench.py's keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``baseline_kind``, the golden accuracy fields) and
``problem``, ``comparison`` (what the pass ran: K1, K4, hybrid or plain),
``config`` (the tuned RunConfig fields), ``autotune_s``, ``comparisons``,
``seconds``, the :func:`roofline` fields and ``card`` (the card's name and
power limit, null on the CPU). It writes no file.

Not ported (TPU-only, as ``runtime/health.py`` is): bench.py's device-health
probe and gate (``device_health``, ``gate_device_health``, the health
fields, ``BENCH_HEALTHY.json``) and its JAX compile cache.
"""

from __future__ import annotations

import argparse
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

# bench.py's configuration (BASELINE config 2: a ~4.4k-orientation
# quaternion grid × an 8-entry defocus/B-env CTF bank × a 21×21
# displacement lattice at N = 224), with its env knobs and defaults.
N_PIXELS = int(os.environ.get("BENCH_NPIX", 224))
N_IMG = int(os.environ.get("BENCH_NIMG", 64))
QUAT_GRID = int(os.environ.get("BENCH_QUATGRID", 15))  # → 4352 orientations
MAX_DISP, DISP_STEP = 20, 2
REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
BASELINE_SAMPLE_OC = int(os.environ.get("BENCH_BASELINE_SAMPLE", 4))

METRIC = "image×orientation×ctf comparisons/s/chip"


def build_problem():
    """bench.py's problem on the port's host layer: the same parameters,
    seed-0 draws and model; the images raw unit noise."""
    from ..core.orientations import build_orientations
    from ..io.map_io import ImageStack
    from ..io.model_io import AA_DENSITY, AA_RADIUS, Model
    from ..params import BioEMParams

    p = BioEMParams(
        pixel_size=1.06, n_pixels=N_PIXELS, use_quaternions=True,
        grid_points_quaternion=QUAT_GRID, n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=4, start_defocus=0.5, end_defocus=2.5, n_env=2,
        start_bfactor=2.0, end_bfactor=100.0, max_displace_center=MAX_DISP,
        grid_space_center=DISP_STEP,
    ).finalize_ctf_mode()
    orients = build_orientations(p)
    rng = np.random.default_rng(0)
    npts = 500
    # uniform in a radius-100 Å ball: every rotation projects in-frame at
    # 224 px × 1.06 Å
    u = rng.normal(size=(npts, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * 100.0 * rng.uniform(size=(npts, 1)) ** (1 / 3)).astype(np.float32)
    residues = rng.choice(list(AA_RADIUS), npts)
    radii = np.array([AA_RADIUS[r] for r in residues], np.float32)
    dens = np.array([AA_DENSITY[r] for r in residues], np.float32)
    model = Model(pts, radii, dens, float(dens.sum())).center_density_mass()
    maps = rng.normal(0, 1, (N_IMG, N_PIXELS, N_PIXELS)).astype(np.float32)
    return p, orients, model, ImageStack(maps)


def planted_problem():
    """``tools/problem.build_problem`` at bench.py's size knobs."""
    from .problem import build_problem as build

    return build(n_pix=N_PIXELS, quat_grid=QUAT_GRID, n_img=N_IMG)[:4]


def bench_engine(p, orients, model, images, device=None) -> dict:
    """Autotune (outside the timed span), build the engine, one warm pass
    (it captures the block loop's graph on the card), then the best of
    ``REPEATS`` passes, each ending in a synchronise and a host read of
    the state. The tuner's threshold (run.AUTOTUNE_MIN_COMPARISONS) is
    above bench.py's problem, which bench.py tunes, so the tuner is on
    unless the environment (``BIOEM_TPU_AUTOTUNE``) says otherwise.
    Returns the per-card rate, the comparisons, the best seconds, the
    tuning seconds, the engine that ran and its final results."""
    import torch

    from ..config import RunConfig, resolve_device
    from ..run import make_engine, maybe_autotune

    device = resolve_device(device)
    cfg = RunConfig.from_env()
    if cfg.autotune is None:
        cfg.autotune = True
    t0 = time.perf_counter()
    cfg = maybe_autotune(p, orients, model, images, cfg, device=device)
    autotune_s = time.perf_counter() - t0
    eng = make_engine(p, orients, model, images, cfg, device=device)

    def one_pass():
        state = eng.run()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        np.asarray(state.total.cpu())
        return state

    one_pass()
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        state = one_pass()
        best = min(best, time.perf_counter() - t0)
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    n_cards = cfg.mesh_images * cfg.mesh_orient
    return {"rate": comparisons / best / n_cards, "comparisons": comparisons, "seconds": best,
            "autotune_s": autotune_s, "engine": eng, "results": eng.results(state)}


def lattice_logpro(cc, s_c, ss_c, sref, ssref, ntot):
    """The reference's log-posterior at each lattice point, without the CTF
    prior (bioem_algorithm.h:18-70; tools/oracle.calc_logpro with the
    prior's terms at zero), vectorised in f64."""
    forlog = ss_c * ntot - s_c * s_c
    firstele = (ntot * (ssref * ss_c - cc * cc) + 2 * sref * s_c * cc - ssref * s_c * s_c
                - sref ** 2 * ss_c)
    return (3 - ntot) * 0.5 * np.log(firstele) + (ntot * 0.5 - 2) * np.log((ntot - 2) * forlog)


def bench_numpy_baseline(p, orients, model, images):
    """Reference-algorithm proxy: full irfft2 CC + f64 logpro at the
    lattice, for ``BASELINE_SAMPLE_OC`` CTFs of one orientation; best of 2
    (a contended host can run one pass several times slower), comparisons/s
    scaled by the host's cores."""
    from ..core.ctf import build_ctf_bank
    from ..params import displacement_lists, make_ctf_grid
    from .oracle import project, rotmat_quat

    n = p.n_pixels
    grid = make_ctf_grid(p)
    bank = build_ctf_bank(p, grid)
    _disp, cent = displacement_lists(p)
    maps = images.maps
    img_fft_c = np.conj(np.fft.rfft2(maps))
    flat = maps.reshape(len(maps), -1)
    sref = flat.sum(1)[:, None, None]
    ssref = (flat ** 2).sum(1)[:, None, None]
    ntot = p.n_total_pixels
    proj = project(p, model.points.astype(np.float64), model.radii, model.densities,
                   model.norm_den, rotmat_quat(orients.angles[0]))
    proj_fft = np.fft.rfft2(proj)

    n_sample = min(BASELINE_SAMPLE_OC, grid.n)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for c in range(n_sample):
            conv = proj_fft * np.conj(bank[c])
            s_c = conv[0, 0].real
            ss_c = (np.sum(np.abs(conv[:, 1:-1]) ** 2) * 2
                    + np.sum(np.abs(conv[:, [0, -1]]) ** 2)) / ntot
            cc_full = np.fft.irfft2(conv[None] * img_fft_c, s=(n, n))  # (I, N, N)
            cc = cc_full[:, cent][:, :, cent]  # (I, D, D)
            logpro = lattice_logpro(cc, s_c, ss_c, sref, ssref, ntot)
            mx = logpro.max(axis=(1, 2))
            np.exp(logpro - mx[:, None, None]).sum(axis=(1, 2))
        best = min(best, time.perf_counter() - t0)
    return n_sample * len(maps) / best * (os.cpu_count() or 1)


def roofline(p, run: dict) -> dict:
    """The pass against the least time one H100 could take for its
    comparisons (``tools/problem.compare_bound`` over the whole pass: K1
    and K4 with stage 1 in 3xTF32 on the tensor cores; the hybrid's K3 by
    :func:`problem.cc_bound`; the plain branch in f32 FMA), and the
    achieved rate of bench.py's useful f32 operations per comparison
    (8·D·M·F + 4·D²·F). ``{}`` off the card, as bench.py's accounting
    is off the TPU."""
    from .golden_error_budget import comparison_of
    from .problem import cc_bound, compare_bound

    eng = run["engine"]
    if eng.device.type != "cuda":
        return {}
    import torch

    n, f, d = p.n_pixels, p.n_fft_1d, p.nx_disp
    m = n // eng.n_fold
    dims = (eng.n_orient, eng.n_ctf, eng.n_img, n, f, d, m, eng.n_fold)
    ran = comparison_of(eng)
    if ran == "hybrid":
        ms, by = cc_bound(*dims)
    else:
        ms, by = compare_bound(*dims, tensor_cores=ran != "plain")
    useful = 8 * d * m * f + 4 * d * d * f
    return {
        "device_kind": torch.cuda.get_device_name(eng.device),
        "useful_f32_flops_per_comparison": useful,
        "achieved_useful_tflops": run["rate"] * useful / 1e12,
        "bound_s": ms * 1e-3,
        "bound_by": by,
        "roofline_pct": 100.0 * ms * 1e-3 / run["seconds"],
    }


# Golden cases on the card (the test suite pins the CPU): CTF mode + Euler
# grid, PSF mode + quaternion list, and the MRC particle-stack ingest.
ACCURACY_CASES = {
    "case_a_euler_ctf": ("maps.txt", ()),
    "case_b_quat_psf": ("maps.txt", ("--ReadOrientation", "quat.txt")),
    "case_c_mrc_stack": ("maps.mrc", ("--ReadMRC",)),
}

# The production-N (224) golden, reported on its own: its |ΔlogP| is set
# by the reference binary's own float32 pixel path (the f64 oracle sits
# 7.7e-2 from it; tools/golden_error_budget.py).
ACCURACY_CASES_N224 = {
    "case_n_n224": ("maps.txt", ("--ReadOrientation", "euler.txt")),
}


def bench_accuracy(cases=None):
    """Worst max |ΔlogP| against the reference binary's golden outputs over
    ``cases`` (default :data:`ACCURACY_CASES`), each through the port's
    CLI in a temporary copy of the case; None if no golden is present."""
    from ..cli import main as cli_main
    from .golden_error_budget import DATA, parse_golden

    worst = None
    for case, (maps_file, extra) in (cases or ACCURACY_CASES).items():
        src = os.path.join(DATA, case)
        if not os.path.isdir(src):
            continue
        with tempfile.TemporaryDirectory() as td:
            work = os.path.join(td, "case")
            shutil.copytree(src, work)
            old = os.getcwd()
            os.chdir(work)
            try:
                with contextlib.redirect_stdout(io.StringIO()):  # one JSON line out
                    rc = cli_main(["--Modelfile", "model.txt", "--Particlesfile", maps_file,
                                   "--Inputfile", "param.txt", "--OutputFile",
                                   "Output_Probabilities.port", *extra])
                if rc != 0:
                    raise RuntimeError(f"the CLI returned {rc} on {case}")
                delta = float(np.max(np.abs(parse_golden("Output_Probabilities.port")
                                            - parse_golden("Output_Probabilities.golden"))))
            finally:
                os.chdir(old)
        worst = delta if worst is None else max(worst, delta)
    return worst


def card_line():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its first card)."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return q.stdout.strip().splitlines()[0].strip()


def _arm_watchdog():
    """Force-exit with an explicit record if the bench hangs.

    A card operation that never returns cannot be interrupted by a signal
    from Python, so a daemon thread hard-exits after ``BENCH_WATCHDOG_S``
    (default 1800 s) with a JSON error line instead of hanging the caller.
    Returns the event that disarms it, or None when disabled (≤ 0)."""
    import threading

    budget = float(os.environ.get("BENCH_WATCHDOG_S", 1800))
    if budget <= 0:
        return None
    done = threading.Event()

    def watchdog():
        if not done.wait(budget):
            print(json.dumps({
                "metric": METRIC, "value": None, "unit": "comparisons/s", "vs_baseline": None,
                "error": "bench_wedged",
                "note": f"no result after {budget:.0f}s: a card operation most likely "
                        "never returned",
            }), flush=True)
            os._exit(1)

    threading.Thread(target=watchdog, daemon=True).start()
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bioem_tpu_torch.tools.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", choices=("bench", "planted"), default="bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card, or the CPU with BIOEM_TPU_FORCE_CPU=1")
    args = ap.parse_args(argv)
    from ..config import resolve_device
    from .golden_error_budget import comparison_of

    done = _arm_watchdog()
    device = resolve_device(args.device)
    if device.type == "cpu":
        # the accuracy cases' CLI resolves its device from the environment
        os.environ["BIOEM_TPU_FORCE_CPU"] = "1"
    p, orients, model, images = build_problem() if args.problem == "bench" else planted_problem()
    run = bench_engine(p, orients, model, images, device=device)
    base_rate = bench_numpy_baseline(p, orients, model, images)
    eng = run["engine"]
    rec = {
        "metric": METRIC,
        "value": run["rate"],
        "unit": "comparisons/s",
        # a live NumPy reimplementation of the reference algorithm scaled
        # by the host's cores, not the reference's published scaling
        "vs_baseline": run["rate"] / base_rate,
        "baseline_kind": "numpy-proxy×cores",
        "max_abs_dlogp_vs_reference": bench_accuracy(),
        "accuracy_cases": len(ACCURACY_CASES),
        "max_abs_dlogp_vs_reference_n224": bench_accuracy(ACCURACY_CASES_N224),
        "problem": args.problem,
        "comparison": comparison_of(eng),
        "config": {"orient_block": eng.o_block, "use_kernels": eng.use_kernels,
                   "fused_lse": eng.fused_lse, "fused_batched": eng.fused_batched,
                   "kernel_img_tile": eng.i_block},
        "autotune_s": run["autotune_s"],
        "comparisons": run["comparisons"],
        "seconds": run["seconds"],
        **roofline(p, run),
        "card": card_line() if device.type == "cuda" else None,
    }
    if done is not None:
        done.set()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
