"""The production problem every tool of the port runs, and its work counts.

:func:`build_problem` is the JAX package's benchmark problem (bench.py's
BASELINE config 2: N = 224, 8 CTFs, D = 21 displacements at stride 2, a
500-point model in 14 radius groups) rebuilt with the port's host layer
and seed 0, with one planted projection per image so that the posterior
has a known maximum. ``n_orient`` replaces the quaternion grid by a
super-Fibonacci list of that size (the reference's 4608 and 36864 lists;
``tools/scale_bench.py`` in the JAX package builds it the same way) and
``n_img`` sets the number of images; neither changes a width.

:func:`compare_work`, :func:`compare_bound` and :func:`cc_bound` count the
operations and bytes of one comparison block (K1, K4; K3), so that
chip_smoke.py, ``tools/profile_block.py`` and ``tools/bench.py`` state the
same bound; :func:`bound` turns a
count into the least time one H100 could take for it.
"""

from __future__ import annotations

import numpy as np

SEED = 0

# Published dense peaks of one H100 SXM (NVIDIA's data sheet) and its
# memory rate, for bound().
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "f64": 67e12}
HBM_BYTES_PER_S = 3.35e12


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


def compare_bytes(o, c, i, n, f, d, m) -> int:
    """Bytes a comparison block (K1, K4) must move: the projection, CTF and
    image spectra, the lattice weights and a_u/b_u read once, its four
    (O·C, I) outputs written once."""
    return 4 * (2 * (o + c + i) * n * f + 2 * d * m + 2 * d * f + 2 * o * c * i + 4 * o * c * i)


def compare_bound(o, c, i, n, f, d, m, n_fold, tensor_cores: bool = False) -> tuple:
    """K1's (f32 FMA) or K4's (stage 1 in 3xTF32 on the tensor cores)
    bound, from :func:`compare_work` and :func:`compare_bytes`."""
    w = compare_work(o, c, i, n, f, d, m, n_fold)
    ops = ({"tf32": 3 * w["stage1"], "f32": w["rest"]} if tensor_cores
           else {"f32": w["stage1"] + w["rest"]})
    return bound(ops, compare_bytes(o, c, i, n, f, d, m))


def cc_bound(o, c, i, n, f, d, m, n_fold) -> tuple:
    """K3's bound: stage 1 on the tensor cores as K1's, the conv bank and
    the images read once, the (O·C, I, D, D) lattice written once."""
    w = compare_work(o, c, i, n, f, d, m, n_fold, conv_in=True)
    return bound({"tf32": 3 * w["stage1"], "f32": w["rest"]},
                 4 * (2 * (o * c + i) * n * f + 2 * d * m + 2 * d * f + o * c * i * d * d))


def prologue_bound(o, g, pp) -> tuple:
    """G3's bound (ops/project_cuda.project_prologue) for O orientations of
    a G × Pp slot layout: the angle rows and the model's slots (points,
    radii, densities), the stencil sums and norm_den read once, i0, j0, de
    (G, O, Pp) and the scale written once; ~20 f32 operations per slot and
    orientation (the rotated x and y, the snap, the sphere's reach) and 2
    f64 (tempden's product and add)."""
    slots = g * pp
    return bound({"f32": 20 * o * slots, "f64": 2 * o * slots},
                 16 * o + 20 * slots + 4 * g + 4 + 3 * 4 * o * slots + 4 * o)


def raster_bound(o, n, p, s, live) -> tuple:
    """G4's bound (ops/project_cuda.raster_project) for O orientations of a
    P-point model at stencil half-width S on an N × N frame: the angle rows
    and the model (points, radii, densities) and norm_den read once, the
    (O, N, N) projections written once; ~20 f32 operations per point and
    orientation (the rotated x and y, the snap, the masks), and for each of
    the ``live`` (orientation, point) pairs that deposit (the data's count:
    in the frame, nonzero density) ~10 per octant entry of its weights
    ((S + 1)(S + 2)/2, √ and / counted as one), one add per stencil position
    ((2S + 1)²) and 2 f64 per octant entry (tempden); one multiply per
    output pixel (the scale)."""
    w = (s + 1) * (s + 2) // 2
    return bound({"f32": 20 * o * p + live * (10 * w + (2 * s + 1) ** 2) + o * n * n,
                  "f64": 2 * live * w},
                 16 * o + 20 * p + 4 + 4 * o * n * n)


def build_problem(signal: float = 0.3, n_pix: int = 224, quat_grid: int = 15,
                  n_img: int = 64, max_disp: int = 20, n_orient: int = 0,
                  disp_step: int = 2, n_phase: int = 4, n_env: int = 2):
    """BASELINE config 2 (bench.py:35-77): N=224, 4352 quaternion
    orientations (grid 15), 8 CTFs (4 defocus × 2 B-env), 64 images, D=21
    displacements at stride 2, a 500-point model with PDB residue radii.
    ``n_orient`` > 0: a super-Fibonacci list of that many orientations in
    place of the grid (voluang 1/n_orient). ``disp_step``, ``n_phase`` and
    ``n_env`` widen the lattice and the CTF bank (:data:`REFERENCE_GRID`);
    the seed's draws do not depend on them.

    The images are bench.py's seed-0 noise with one planted projection
    each (a known orientation, CTF and displacement, at ``signal`` times
    the noise level), then normalised per image as the MRC ingest does —
    so the fused f32 comparison applies and the posterior has a clear
    maximum to recover. Returns (p, orients, model, images, planted).
    """
    from ..core.orientations import OrientationSet, build_orientations
    from ..io.map_io import ImageStack, _normalize_stack
    from ..io.model_io import AA_DENSITY, AA_RADIUS, Model
    from ..params import BioEMParams
    from ..utils.so3 import super_fibonacci

    p = BioEMParams(
        pixel_size=1.06, n_pixels=n_pix, use_quaternions=True,
        grid_points_quaternion=quat_grid, n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=n_phase, start_defocus=0.5, end_defocus=2.5, n_env=n_env,
        start_bfactor=2.0, end_bfactor=100.0, max_displace_center=max_disp,
        grid_space_center=disp_step,
    ).finalize_ctf_mode()
    if n_orient:
        orients = OrientationSet(angles=super_fibonacci(n_orient).astype(np.float64),
                                 use_quaternions=True, voluang=1.0 / n_orient, priors=None)
    else:
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


# The reference's production grid (BASELINE.md, first table; SURVEY.md §6):
# 4608 quaternions × 32 CTFs (4 B-env × 8 defocus) × 81×81 displacements
# at stride 1 (D = 81, M = N = 224: K1 on two warpgroups, no K4).
REFERENCE_GRID = dict(n_orient=4608, max_disp=40, disp_step=1, n_phase=8, n_env=4)
# The same grid searching ±60 pixels (D = 121), a lattice the earlier K1
# refused for its shared memory.
WIDE_GRID = {**REFERENCE_GRID, "max_disp": 60}


def reference_grid_params(n_pix: int = 224, max_disp: int = 40) -> str:
    """:data:`REFERENCE_GRID` (or, with ``max_disp`` 60, :data:`WIDE_GRID`)
    as a parameter file for the CLI (to be read with ``--ReadOrientation``
    and a quaternion list)."""
    return (f"PIXEL_SIZE 1.06\nNUMBER_PIXELS {n_pix}\nCTF_B_ENV 2.0 100.0 4\n"
            f"CTF_DEFOCUS 0.5 2.5 8\nCTF_AMPLITUDE 0.1 0.1 1\nDISPLACE_CENTER {max_disp} 1\n"
            "USE_QUATERNIONS\n")


def write_reference_grid(work: str, problem) -> list:
    """A problem built at :data:`REFERENCE_GRID` (or :data:`WIDE_GRID`, or
    a cut of either) written to ``work`` as the
    CLI reads it: ``param.txt``, the quaternion list ``quat.txt``, the
    model as text and the images as an MRC stack (the reference's MRC
    sections are the maps transposed). Returns the CLI's arguments."""
    import os

    from ..io.mrc import write_mrc
    from ..utils.so3 import write_quaternion_list

    p, orients, model, images = problem[:4]
    with open(os.path.join(work, "param.txt"), "w") as f:
        f.write(reference_grid_params(p.n_pixels, p.max_displace_center))
    write_quaternion_list(os.path.join(work, "quat.txt"), orients.angles)
    with open(os.path.join(work, "model.txt"), "w") as f:
        for (x, y, z), r, d in zip(model.points, model.radii, model.densities):
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {r:.6f} {d:.6f}\n")
    write_mrc(os.path.join(work, "particles.mrc"), np.transpose(images.maps, (0, 2, 1)),
              p.pixel_size)
    return ["--Modelfile", "model.txt", "--Particlesfile", "particles.mrc", "--ReadMRC",
            "--Inputfile", "param.txt", "--ReadOrientation", "quat.txt"]


def nearest_orientations(orients, i: int, k: int) -> np.ndarray:
    """Orientation ``i`` and the ``k`` − 1 nearest distinct rotations of
    ``orients`` (quaternions: q and −q are one rotation, so the distance is
    1 − |q·q'| and the antipode of ``i`` is skipped)."""
    q = orients.angles.astype(np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    dist = 1.0 - np.abs(q @ q[i])
    order = np.argsort(dist, kind="stable")
    keep = [int(j) for j in order if j == i or dist[j] > 1e-9]
    return np.array([i] + [j for j in keep if j != i][: k - 1])


def orientation_cut(problem, per_plant: int):
    """``problem`` (build_problem's tuple) cut to each planted orientation
    and its ``per_plant`` − 1 nearest neighbours (nearest_orientations):
    the posterior's mass at every image stays in the cut. The planted
    indices are renumbered into the cut; voluang stays the full set's."""
    from ..core.orientations import OrientationSet

    p, orients, model, images, planted = problem
    idx = np.unique(np.concatenate([nearest_orientations(orients, int(o), per_plant)
                                    for o in planted["orient"]]))
    cut = OrientationSet(angles=orients.angles[idx], use_quaternions=orients.use_quaternions,
                         voluang=orients.voluang, priors=None)
    renum = {int(o): k for k, o in enumerate(idx)}
    planted = {**planted, "orient": np.array([renum[int(o)] for o in planted["orient"]])}
    return p, cut, model, images, planted


def plant(p, orients, model, rng, n_img: int) -> dict:
    """Noise-free images of the model: per image a random orientation of
    ``orients``, CTF and lattice displacement, made with the port's plain
    projection."""
    import torch

    from ..core.ctf import build_ctf_bank
    from ..core.orientations import rotation_matrices
    from ..core.projection import make_fourier_projection_spec, project_fourier_batch
    from ..params import displacement_lists, make_ctf_grid

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
    rotm = rotation_matrices(t(orients.angles[o_idx].astype(np.float32)), True)
    pr, pi = project_fourier_batch(
        fspec, rotm, t(model.points[gidx]), t(model.radii[gidx]),
        t(model.densities[gidx] * pmask), t(np.float32(model.norm_den)),
        t(np.ascontiguousarray(st.real)), t(np.ascontiguousarray(st.imag)), t(st_sums),
    )
    spec = (pr.numpy() + 1j * pi.numpy()) * np.conj(bank[c_idx])
    maps = np.fft.irfft2(spec, s=(n, n))
    maps = np.stack([np.roll(m, (int(a), int(b)), axis=(0, 1)) for m, a, b in zip(maps, dx, dy)])
    return dict(maps=maps.astype(np.float32), orient=o_idx, ctf=c_idx, dx=dx, dy=dy)
