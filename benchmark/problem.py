"""The benchmark's inputs, made from a configuration, a traffic mix and a seed.

Frozen here so that no change to the program moves them: the orientation
list, the model (points, residue radii and densities), the candidate
models of a ranking mix, and the particle images, each with one planted
projection of a known orientation, CTF and displacement in seeded noise,
normalised per image as BioEM's MRC ingest does (map.cpp:830-845). The
planting projection and CTF are those of the plain reference that the
configuration names (``references/<reference>.py``). Every array is drawn from
``numpy.random.default_rng`` of the seed, so a seed gives the same inputs on
every machine, and every seed gives the same sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .registry import reference

# Residue radii (Å) and electron counts of BioEM's PDB reader
# (model.cpp:792-844), by residue name.
AA_RADIUS = {
    "CYS": 2.75, "PHE": 3.2, "LEU": 3.1, "TRP": 3.4, "VAL": 2.95,
    "ILE": 3.1, "MET": 3.1, "HIS": 3.05, "TYR": 3.25, "ALA": 2.5,
    "GLY": 2.25, "PRO": 2.8, "ASN": 2.85, "THR": 2.8, "SER": 2.6,
    "ARG": 3.3, "GLN": 3.0, "ASP": 2.8, "LYS": 3.2, "GLU": 2.95,
}
AA_DENSITY = {
    "CYS": 64.0, "PHE": 88.0, "LEU": 72.0, "TRP": 108.0, "VAL": 64.0,
    "ILE": 72.0, "MET": 80.0, "HIS": 82.0, "TYR": 96.0, "ALA": 48.0,
    "GLY": 40.0, "PRO": 62.0, "ASN": 66.0, "THR": 64.0, "SER": 56.0,
    "ARG": 93.0, "GLN": 78.0, "ASP": 59.0, "LYS": 79.0, "GLU": 53.0,
}


@dataclass
class PointModel:
    points: np.ndarray  # (P, 3) float32, centred on the density mass
    radii: np.ndarray  # (P,) float32
    densities: np.ndarray  # (P,) float32
    norm_den: float


@dataclass
class Problem:
    cfg: dict
    quats: np.ndarray  # (O, 4) float32
    voluang: float
    models: list  # PointModel, the first the one the images were planted from
    images: np.ndarray  # (I, N, N) float32
    check_images: np.ndarray  # indices of the images the check judges


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator per (seed, stream): any whole seed, negative or past 64
    bits, is taken modulo 2**64."""
    return np.random.default_rng([seed % (1 << 64), stream])


def orientations(spec: dict) -> tuple:
    """(quaternions (O, 4) float32, voluang) of an ``orientations`` entry: a
    super-Fibonacci list of ``n`` rotations (Alexa, CVPR 2022; a list read
    with --ReadOrientation has voluang 1/n)."""
    if spec["kind"] == "super_fibonacci":
        n = spec["n"]
        s = np.arange(n, dtype=np.float64) + 0.5
        t = s / n
        a = 2.0 * math.pi * s
        r, big_r = np.sqrt(t), np.sqrt(1.0 - t)
        psi = 1.533751168755204288118041
        q = np.stack([r * np.sin(a / math.sqrt(2.0)), r * np.cos(a / math.sqrt(2.0)),
                      big_r * np.sin(a / psi), big_r * np.cos(a / psi)], 1)
        return q.astype(np.float32), 1.0 / n
    raise ValueError(f"unknown orientation kind {spec['kind']!r}")


def centred(points: np.ndarray, radii: np.ndarray, dens: np.ndarray) -> PointModel:
    """The model moved to its density-weighted centre in float32
    (model.cpp:604-672); norm_den is the total density."""
    norm_den = float(dens.astype(np.float64).sum())
    cm = (points * dens[:, None]).sum(axis=0) / np.float32(norm_den)
    return PointModel((points - cm).astype(np.float32), radii, dens, norm_den)


def base_model(cfg: dict, rng: np.random.Generator) -> PointModel:
    """``n_points`` residues uniform in a ball of ``radius_A``, each residue
    drawn from BioEM's table."""
    m = cfg["model"]
    u = rng.normal(size=(m["n_points"], 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * m["radius_A"] * rng.uniform(size=(m["n_points"], 1)) ** (1 / 3)).astype(np.float32)
    names = rng.choice(sorted(AA_RADIUS), m["n_points"])
    radii = np.array([AA_RADIUS[r] for r in names], np.float32)
    dens = np.array([AA_DENSITY[r] for r in names], np.float32)
    return centred(pts, radii, dens)


def normalise(stack: np.ndarray) -> np.ndarray:
    """Zero mean and unit population σ per image, in BioEM's order of
    operations (map.cpp:830-845)."""
    flat = stack.reshape(stack.shape[0], -1).astype(np.float64)
    mean = flat.mean(axis=1)
    sig = np.sqrt((flat ** 2).mean(axis=1) - mean * mean)
    out = stack / sig[:, None, None].astype(np.float32) - (mean / sig)[:, None, None].astype(np.float32)
    return out.astype(np.float32)


def plant(cfg: dict, quats: np.ndarray, model: PointModel, rng: np.random.Generator,
          n_img: int) -> np.ndarray:
    """Noise-free images of ``model``: per image a random orientation, CTF
    and lattice displacement, through the plain reference's projection and
    CTF bank."""
    ref = reference(cfg)
    n = cfg["n_pixels"]
    bank = ref.ctf_bank(cfg, ref.ctf_grid(cfg))
    disp = ref.displacements(cfg)
    o = rng.integers(0, quats.shape[0], n_img)
    c = rng.integers(0, bank.shape[0], n_img)
    dx = disp[rng.integers(0, disp.shape[0], n_img)]
    dy = disp[rng.integers(0, disp.shape[0], n_img)]
    spec = ref.project(cfg, torch.as_tensor(quats[o]), model, "cpu").numpy() * np.conj(bank[c])
    maps = np.fft.irfft2(spec, s=(n, n))
    maps = np.stack([np.roll(m, (int(a), int(b)), axis=(0, 1)) for m, a, b in zip(maps, dx, dy)])
    return maps


def build(cfg: dict, mix: dict, seed: int) -> Problem:
    """The problem of one run: the configuration's orientations and model,
    ``mix["n_models"]`` models (the first the base model, the others it
    with every point moved by N(0, ``model_jitter_A``) Å, the same residues),
    ``mix["n_images"]`` images planted from the first at ``signal`` times
    the noise, and ``mix["check_images"]`` of them drawn for the check."""
    quats, voluang = orientations(cfg["orientations"])
    model = base_model(cfg, rng_for(seed, 1))
    models = [model]
    jit = rng_for(seed, 2)
    for _ in range(mix.get("n_models", 1) - 1):
        moved = model.points + jit.normal(0.0, mix["model_jitter_A"], model.points.shape).astype(np.float32)
        models.append(centred(moved.astype(np.float32), model.radii, model.densities))
    n_img = mix["n_images"]
    rng = rng_for(seed, 3)
    noise = rng.normal(0.0, 1.0, (n_img, cfg["n_pixels"], cfg["n_pixels"])).astype(np.float32)
    sig = plant(cfg, quats, model, rng, n_img)
    sig = sig / sig.reshape(n_img, -1).std(axis=1)[:, None, None]
    images = normalise((noise + cfg["images"]["signal"] * sig).astype(np.float32))
    check = np.sort(rng_for(seed, 4).choice(n_img, min(mix["check_images"], n_img), replace=False))
    return Problem(cfg, quats, voluang, models, images, check)
