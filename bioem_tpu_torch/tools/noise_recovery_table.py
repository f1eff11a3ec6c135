"""Recovery accuracy against image noise, through the simulator closure loop.

The port's counterpart of the JAX package's ``tools/noise_recovery_table.py``:
how the grid engine and the continuous refinement (``refine_results``, the
CLI's ``--Refine --RefineCTF``) degrade with noise. The forward model is
the port's simulator (``simulator.synthesize_best_map``: the independent
NumPy raster and CTF path of ``--PrintBestCalMap``), not the refinement's
smooth surrogate, so the loop closes across two implementations. Per
noise level, each trial plants a truth off the grid in orientation (a grid
orientation turned by |ω| ~ 0.26 rad), displacement (sub-pixel, within
±4) and CTF phase (uniform between the two grid phases) at N = 48, adds
Gaussian noise at σ = level × the signal's std (the reference's
WITHNOISE), normalises the image, runs the engine (the grid seed) and the
refinement, and records the angular, displacement and defocus errors of
both. Trial ``t`` draws from seed ``1000·t + 17``, as in the JAX tool.

    python -m bioem_tpu_torch.tools.noise_recovery_table [trials] [--out FILE]

(default 4 trials at every level of ``NOISE_LEVELS``). Prints one JSON line
per level and a markdown table. The card, or the CPU with
``BIOEM_TPU_FORCE_CPU=1``.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np
import torch

# The matched filter integrates over N² pixels, so per-pixel noise below
# the signal barely moves recovery at N = 48; the breakdown is at 2-8×.
NOISE_LEVELS = (0.0, 0.3, 1.0, 2.0, 4.0, 8.0)


def tiny_params(**kw):
    """A small CTF-mode configuration (the JAX suite's ``tiny_params``)."""
    from ..params import BioEMParams

    defaults = dict(
        pixel_size=1.5, n_pixels=16, n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=2, start_defocus=0.5, end_defocus=1.5, n_env=2,
        start_bfactor=1.0, end_bfactor=100.0, max_displace_center=2,
        grid_space_center=1, grid_points_alpha=2, grid_points_beta=2,
    )
    defaults.update(kw)
    return BioEMParams(**defaults).finalize_ctf_mode()


def tiny_model(rng, n_points=12, spread=6.0):
    """Random points, radii and densities (the JAX suite's ``tiny_model``)."""
    from ..io.model_io import Model

    pts = rng.uniform(-spread, spread, size=(n_points, 3)).astype(np.float32)
    radii = rng.uniform(1.0, 3.2, size=n_points).astype(np.float32)
    dens = rng.uniform(40.0, 100.0, size=n_points).astype(np.float32)
    return Model(pts, radii, dens, float(dens.astype(np.float64).sum()))


def plant(level: float, trial: int, device=None) -> tuple:
    """(engine, grid results, truth) of one trial, before refinement."""
    from ..config import RunConfig
    from ..core.engine import BioEMEngine
    from ..core.orientations import build_orientations, rotation_matrices
    from ..io.map_io import ImageStack
    from ..params import BestParams
    from ..refine import _rotmat_to_quaternion, exp_so3
    from ..simulator import synthesize_best_map

    rng = np.random.default_rng(1000 * trial + 17)
    p = tiny_params(
        n_pixels=48, pixel_size=1.5, use_quaternions=True, grid_points_quaternion=3,
        max_displace_center=6, grid_space_center=2, n_phase=2, start_defocus=0.3,
        end_defocus=0.7, n_env=1, start_bfactor=40.0, end_bfactor=40.0,
    )
    orients = build_orientations(p)
    model = tiny_model(rng, n_points=10)
    base_idx = int(rng.integers(0, orients.n))
    base = rotation_matrices(torch.as_tensor(orients.angles[base_idx]), True).numpy()
    base = base.astype(np.float64)
    # |ω| ~ 0.26 rad: above the ~0.1 rad raster-vs-smooth bias floor at this
    # N, well inside the ~1 rad grid spacing
    w = rng.normal(0.0, 0.15, 3)
    rot_star = exp_so3(torch.as_tensor(w, dtype=torch.float32)).numpy() @ base
    q_star = _rotmat_to_quaternion(rot_star[None])[0]
    d_star = rng.uniform(-4.0, 4.0, 2)

    boot_images = ImageStack(rng.normal(0, 1, (1, p.n_pixels, p.n_pixels)).astype(np.float32))
    boot = BioEMEngine(p, orients, model, boot_images, RunConfig(orient_block=4), device=device)
    grid_pha = boot.banks.pha.cpu().numpy()
    pha_star = float(rng.uniform(grid_pha.min(), grid_pha.max()))
    bp = BestParams(pixel_size=p.pixel_size, n_pixels=p.n_pixels, use_quaternions=True,
                    orient=tuple(q_star), amp=float(boot.banks.amp[0]), phase=pha_star,
                    env=float(boot.banks.env[0]))
    sim = synthesize_best_map(bp, model)
    n = p.n_pixels
    nf = n // 2 + 1
    spec = np.fft.rfft2(sim.conv_map)
    k1 = ((np.arange(n) + n // 2) % n - n // 2)[:, None]
    k2 = np.arange(nf)[None, :]
    spec = spec * np.exp(-2j * np.pi * (k1 * d_star[0] + k2 * d_star[1]) / n)
    img = np.fft.irfft2(spec, s=(n, n))
    if level > 0:
        img = img + rng.normal(0.0, level * img.std(), img.shape)
    img = (img - img.mean()) / img.std()
    eng = BioEMEngine(p, orients, model, ImageStack(img[None].astype(np.float32)),
                      RunConfig(orient_block=4), device=device)
    res = eng.results(eng.run())
    truth = {"rot": rot_star, "d": d_star, "pha": pha_star, "grid_pha": grid_pha}
    return eng, res, truth


def one_trial(level: float, trial: int, device=None) -> dict:
    """Errors of the grid seed and the refined output of one trial."""
    from ..core.orientations import rotation_matrices
    from ..refine import refine_results

    eng, res, truth = plant(level, trial, device)
    out = refine_results(eng, res, refine_ctf=True)
    rot_star, d_star, pha_star = truth["rot"], truth["d"], truth["pha"]

    def ang_err(r):
        tr = np.trace(np.asarray(r, np.float64) @ rot_star.T)
        return math.acos(min(1.0, max(-1.0, (tr - 1.0) / 2.0)))

    seed_rot = rotation_matrices(
        torch.as_tensor(eng.orients.angles[res.best_orient[0]]), True).numpy()
    # phase → defocus [μm] (the CLI's output unit): pha / 2π / λ · 1e-4
    to_um = 1e-4 / (2.0 * math.pi * eng.p.electron_wavelength)
    return {
        "ang_seed": ang_err(seed_rot),
        "ang_refined": ang_err(out.rotmat[0]),
        "d_seed": float(np.hypot(res.best_cent_x[0] - d_star[0], res.best_cent_y[0] - d_star[1])),
        "d_refined": float(np.hypot(out.cent_x[0] - d_star[0], out.cent_y[0] - d_star[1])),
        "defocus_um_seed": abs(float(truth["grid_pha"][res.best_conv[0]]) - pha_star) * to_um,
        "defocus_um_refined": abs(float(out.pha[0]) - pha_star) * to_um,
    }


def table(k_trials: int = 4, levels=NOISE_LEVELS, device=None, say=None) -> list:
    """One row per noise level: the median of each error over the trials."""
    rows = []
    for level in levels:
        trials = [one_trial(level, t, device) for t in range(k_trials)]
        row = {"noise_over_signal": level, "trials": k_trials}
        for key in trials[0]:
            row[key + "_median"] = float(np.median([t[key] for t in trials]))
        rows.append(row)
        if say:
            say(json.dumps(row))
    return rows


def markdown(rows: list) -> str:
    lines = ["| σ/signal | ang seed→refined [rad] | d seed→refined [pix] "
             "| defocus seed→refined [μm] |", "|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['noise_over_signal']} "
            f"| {r['ang_seed_median']:.3f} → {r['ang_refined_median']:.3f} "
            f"| {r['d_seed_median']:.2f} → {r['d_refined_median']:.2f} "
            f"| {r['defocus_um_seed_median']:.3f} → {r['defocus_um_refined_median']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    rows = table(int(args[0]) if args else 4, say=lambda msg: print(msg, flush=True))
    print("\n" + markdown(rows))
    if out:
        with open(out, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
