"""Planted-parameter recovery: the port's end-to-end drive on the card.

The port's counterpart of the JAX package's ``examples/planted_recovery.py``,
same scenario: a particle image synthesised with the all-f64 oracle's
forward model (``tools/oracle.py``) from a known orientation (#17 of a
quaternion grid), CTF (#3) and displacement (2, −2) at N = 64 with 10 %
noise (seed 7), beside a pure-noise image; the posterior engine must
recover the planted parameters and rank the planted image above the
noise, then the continuous refinement (``refine_results``) must not lose
log-posterior and must stay at the on-grid truth. Prints
``PLANTED-PARAMETER RECOVERY: PASS`` and ``CONTINUOUS REFINEMENT: PASS``
and exits non-zero if either fails.

    python -m bioem_tpu_torch.examples.planted_recovery        # the card
    BIOEM_TPU_FORCE_CPU=1 python -m bioem_tpu_torch.examples.planted_recovery
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

TRUE_ORIENT, TRUE_CONV, TRUE_DX, TRUE_DY = 17, 3, 2, -2


def scenario():
    """(params, orientations, model, images): the planted image and a
    pure-noise image at N = 64."""
    from ..core.ctf import build_ctf_bank
    from ..core.orientations import build_orientations
    from ..io.map_io import ImageStack
    from ..io.model_io import Model
    from ..params import BioEMParams, make_ctf_grid
    from ..tools.oracle import project, rotmat_quat

    n = 64
    p = BioEMParams(
        pixel_size=2.0, n_pixels=n,
        use_quaternions=True, grid_points_quaternion=3,
        n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=4, start_defocus=0.5, end_defocus=2.5,
        n_env=2, start_bfactor=2.0, end_bfactor=100.0,
        max_displace_center=4, grid_space_center=2,
    ).finalize_ctf_mode()
    orients = build_orientations(p)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-25, 25, (40, 3)).astype(np.float32)
    # radii quantised to 0.1 Å → ≤ 15 distinct values, so the engine takes
    # the Fourier radius-group projection (K2), which refinement also needs
    radii = np.round(rng.uniform(2.0, 3.4, 40), 1).astype(np.float32)
    dens = rng.uniform(40, 110, 40).astype(np.float32)
    model = Model(pts, radii, dens, float(dens.sum())).center_density_mass()
    bank = build_ctf_bank(p, make_ctf_grid(p))
    proj = project(p, model.points.astype(np.float64), radii, dens, model.norm_den,
                   rotmat_quat(orients.angles[TRUE_ORIENT]))
    conv = np.fft.irfft2(np.fft.rfft2(proj) * np.conj(bank[TRUE_CONV]), s=(n, n))
    img = np.roll(conv, (TRUE_DX, TRUE_DY), axis=(0, 1))
    img = img + rng.normal(0, 0.1 * img.std(), img.shape)
    img = (img - img.mean()) / img.std()  # normalised as the MRC ingest does
    images = ImageStack(np.stack([img, rng.normal(0, 1, (n, n))]).astype(np.float32))
    return p, orients, model, images


def run(device=None, say=print) -> dict:
    """Drive the scenario on ``device`` (None: the card, or the CPU with
    ``BIOEM_TPU_FORCE_CPU``); returns {"recovered", "refined", "results",
    "comparisons_per_s"}."""
    from ..config import RunConfig
    from ..core.engine import BioEMEngine
    from ..refine import refine_results

    p, orients, model, images = scenario()
    say(f"orientations: {orients.n} ctfs: {p.n_ctf}")
    t0 = time.time()
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=8), device=device)
    dev = eng.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    state = eng.run()
    sync()
    t1 = time.time()
    res = eng.results(state)
    say(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    say(f"run time (incl. set-up and capture): {t1 - t0:.1f}s")
    say(f"logP: {res.log_prob}")
    say(f"best_orient: {res.best_orient} expected {TRUE_ORIENT}")
    say(f"best_conv: {res.best_conv} expected {TRUE_CONV}")
    say(f"best_cent: {res.best_cent_x} {res.best_cent_y} expected ({TRUE_DX},{TRUE_DY})")
    ok = bool(res.best_orient[0] == TRUE_ORIENT and res.best_conv[0] == TRUE_CONV
              and res.best_cent_x[0] == TRUE_DX and res.best_cent_y[0] == TRUE_DY
              and res.log_prob[0] > res.log_prob[1])
    say(f"PLANTED-PARAMETER RECOVERY: {'PASS' if ok else 'FAIL'}")
    t0 = time.time()
    state = eng.run()
    sync()
    t1 = time.time()
    cps = orients.n * p.n_ctf * images.n / (t1 - t0)
    say(f"steady-state: {t1 - t0:.2f}s  {cps:.0f} comparisons/s")

    t0 = time.time()
    ref = refine_results(eng, res, image_indices=[0], n_starts=8, iters=40)
    t1 = time.time()
    say(f"refine time: {t1 - t0:.1f}s  logpro {ref.logpro_seed[0]:.1f} -> "
        f"{ref.logpro_refined[0]:.1f}  cent ({ref.cent_x[0]:+.2f},{ref.cent_y[0]:+.2f})")
    # The planted truth is on the grid, so the polish must stay near the
    # seed and must not lose log-posterior (monotone accept/reject).
    ref_ok = bool(ref.logpro_refined[0] >= ref.logpro_seed[0]
                  and abs(ref.cent_x[0] - TRUE_DX) < 1.0
                  and abs(ref.cent_y[0] - TRUE_DY) < 1.0
                  and np.isfinite(ref.grad_norm[0]))
    say(f"CONTINUOUS REFINEMENT: {'PASS' if ref_ok else 'FAIL'}")
    return {"recovered": ok, "refined": ref_ok, "results": res, "comparisons_per_s": cps}


def main() -> int:
    out = run(say=lambda msg: print(msg, flush=True))
    return 0 if out["recovered"] and out["refined"] else 1


if __name__ == "__main__":
    sys.exit(main())
