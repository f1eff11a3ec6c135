"""End-to-end tutorial: the reference's MODEL_COMPARISON workflow on the port.

The port's counterpart of the JAX package's ``examples/tutorial.py`` (the
BioEM tutorial's model comparison): build two candidate structural models,
forward-simulate a particle stack from model 1 (known orientations, CTF,
displacements, noise), then run the whole pipeline through the port's
command-line surface:

  1. generate a uniform quaternion list   (python -m bioem_tpu_torch.utils.so3)
  2. write an MRC particle stack           (bioem_tpu_torch.io.mrc)
  3. run the posterior engine on model 1   (python -m bioem_tpu_torch.cli ...)
  4. rank the models                       (python -m bioem_tpu_torch.rank ...)

Model 1 must win (the tutorial's acceptance criterion); the script exits
non-zero otherwise. Steps 3 and 4 run on the card, or on the CPU with
``BIOEM_TPU_FORCE_CPU=1``:

    python -m bioem_tpu_torch.examples.tutorial [workdir]

(default workdir: a new temporary directory, printed at the end).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

N_PIX = 32
N_IMG = 10
PIXEL_SIZE = 2.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PARAM = f"""\
PIXEL_SIZE {PIXEL_SIZE}
NUMBER_PIXELS {N_PIX}
USE_QUATERNIONS
CTF_B_ENV 10.0 10.0 1
CTF_DEFOCUS 1.0 1.0 1
CTF_AMPLITUDE 0.1 0.1 1
DISPLACE_CENTER 2 1
"""


def make_model(rng, n_pts=30, spread=20.0):
    from ..io.model_io import AA_DENSITY, AA_RADIUS, Model

    residues = rng.choice(list(AA_RADIUS), n_pts)
    pts = rng.uniform(-spread, spread, (n_pts, 3)).astype(np.float32)
    radii = np.array([AA_RADIUS[r] for r in residues], np.float32)
    dens = np.array([AA_DENSITY[r] for r in residues], np.float32)
    return Model(pts, radii, dens, float(dens.astype(np.float64).sum()))


def write_model(path, m):
    with open(path, "w") as f:
        for k in range(m.n_points):
            f.write(
                f"{m.points[k,0]:.6f} {m.points[k,1]:.6f} {m.points[k,2]:.6f} "
                f"{m.radii[k]:.6f} {m.densities[k]:.6f}\n"
            )


def simulate_stack(rng, model, quats):
    """Forward model: project + CTF-convolve + shift + noise (the physics of
    the simulator, driven directly for a batch)."""
    from ..core.ctf import build_ctf_bank
    from ..params import BioEMParams, make_ctf_grid
    from ..tools.oracle import project, rotmat_quat

    p = BioEMParams(
        pixel_size=PIXEL_SIZE, n_pixels=N_PIX, use_quaternions=True,
        n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=1, start_defocus=1.0, end_defocus=1.0,
        n_env=1, start_bfactor=10.0, end_bfactor=10.0,
        max_displace_center=2, grid_space_center=1,
    ).finalize_ctf_mode()
    kernel = build_ctf_bank(p, make_ctf_grid(p))[0]
    centered = model.center_density_mass()
    maps = []
    for _ in range(N_IMG):
        q = quats[rng.integers(len(quats))]
        proj = project(
            p, centered.points.astype(np.float64), centered.radii,
            centered.densities, centered.norm_den, rotmat_quat(q),
        )
        conv = np.fft.irfft2(np.fft.rfft2(proj) * np.conj(kernel), s=(N_PIX, N_PIX))
        dx, dy = rng.integers(-2, 3, 2)
        conv = np.roll(conv, (dx, dy), axis=(0, 1))
        noise = rng.normal(0, 0.3 * np.abs(conv).max(), conv.shape)
        maps.append(conv + noise)
    return np.stack(maps).astype(np.float32)


def run(work: str, say=print) -> bool:
    """The workflow in ``work``; True when model 1 ranks first."""
    from ..config import resolve_device
    from ..io.mrc import write_mrc
    from ..utils.so3 import super_fibonacci

    resolve_device()  # the card, or the CPU when asked: fail before any work
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(2026)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])

    def tool(*args, **kw):
        return subprocess.run([sys.executable, "-m", *args], cwd=work, env=env, check=True,
                              **kw)

    say("=== 1. models + orientation list ===")
    m1, m2 = make_model(rng), make_model(rng)
    write_model(os.path.join(work, "model1.txt"), m1)
    write_model(os.path.join(work, "model2.txt"), m2)
    tool("bioem_tpu_torch.utils.so3", "64", "quat64.txt", capture_output=True)
    quats = super_fibonacci(64)  # the list's rows at full precision
    with open(os.path.join(work, "param.txt"), "w") as f:
        f.write(PARAM)

    say("=== 2. forward-simulate particles from model 1 ===")
    stack = simulate_stack(rng, m1, quats)
    # MRC stores transposed sections (the reference's map.cpp convention).
    write_mrc(os.path.join(work, "particles.mrc"), np.transpose(stack, (0, 2, 1)), PIXEL_SIZE)

    say("=== 3. posterior run, model 1 (CLI) ===")
    tool("bioem_tpu_torch.cli", "--Modelfile", "model1.txt", "--Particlesfile", "particles.mrc",
         "--ReadMRC", "--Inputfile", "param.txt", "--ReadOrientation", "quat64.txt",
         "--OutputFile", "Output_m1")

    say("=== 4. model ranking (model 1 must win) ===")
    res = tool("bioem_tpu_torch.rank", "--Modelfile", "model1.txt", "--Modelfile", "model2.txt",
               "--Particlesfile", "particles.mrc", "--ReadMRC", "--Inputfile", "param.txt",
               "--ReadOrientation", "quat64.txt", "--OutputFile", "Model_Ranking",
               capture_output=True, text=True)
    say(res.stdout)
    won = "#1 model1.txt" in res.stdout
    say("TUTORIAL: PASS (generating model ranked first)" if won
        else "TUTORIAL: FAIL (model 1 did not win the ranking)")
    say(f"artifacts in {work}")
    return won


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    work = args[0] if args else tempfile.mkdtemp(prefix="bioem_tutorial_")
    return 0 if run(work, say=lambda msg: print(msg, flush=True)) else 1


if __name__ == "__main__":
    sys.exit(main())
