"""Plain reference of the BioEM posterior of a voxel map, in PyTorch at
float64.

The posterior of ``bioem_posterior.py`` (a copy of its grids, CTF bank,
lattice and posterior, from the BioEM reference's formulas and from nothing
of the program under test) for a model read as BioEM reads an MRC density
map (``--ReadModelMRC``, model.cpp:332-416): every voxel a sphere of radius
2·pixel at ((i − nx/2)·pix, (j − ny/2)·pix, (k − nz/2)·pix), i, j, k from 1
in file order (i slowest), its value the sphere's density, the whole moved
to its density-weighted centre in float32 (model.cpp:604-672).

The configuration's ``map`` section says how a map is made from the
problem's residue model (:func:`voxel_map`): a box of ``box``³ voxels at the
pixel size, each residue a Gaussian of its electron count with σ =
``sigma_A`` (Chimera molmap's 0.225 × resolution), and solvent noise
N(0, ``noise_rel`` × the map's largest value) on every voxel, drawn from a
generator seeded by the model's bytes, so that the same model gives the same
map. :func:`project` and :meth:`Posterior.run` take the residue model the
problem holds and derive the voxel model from it (once per model), so the
harness plants and judges with them unchanged.

Each voxel deposits only the disc's pixels, d² < r² (9 at r = 2·pix), in
float64 after BioEM's float32 rotation and snap, as ``bioem_posterior.py``
rounds them; everything after the snap is float64. One radius for every
voxel makes the deposit a sum of the in-frame densities at each voxel's
pixel, shifted by each of the disc's offsets and weighted by its chord.

``precision="tf32"`` is the control, as in ``bioem_posterior.py``: the
cross-correlation's two contractions rounded as a TF32 tensor core rounds
them. The check must find that control wrong.

Work is done in blocks of orientations, and the deposit in chunks of
points, so the tensors fit beside whatever else the card holds.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch

F64 = torch.float64
F32 = torch.float32
C128 = torch.complex128


# ---------------------------------------------------------------------------
# Grids (param.cpp:1336-1620)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CtfGrid:
    amp: np.ndarray  # (C,) float32, (amp, phase, env) flattened in C order
    phase: np.ndarray
    env: np.ndarray
    grid_amp: float
    grid_phase: float
    grid_env: float
    prior_defocus_center: float  # in phase units
    sigma_defocus: float  # in phase units


def _spacing(start: float, end: float, n: int) -> float:
    # The reference's quirk: (end - start)/n, and the start itself when n == 1.
    return start if n == 1 else (end - start) / n


def ctf_grid(cfg: dict) -> CtfGrid:
    """The CTF parameter grid of a configuration's ``ctf`` and ``priors``
    (CTF mode: defocus in µm turned into phase, param.cpp:600-607)."""
    c, pr = cfg["ctf"], cfg["priors"]
    f = math.pi * 2.0 * 10000.0 * c["electron_wavelength"]
    sp, ep = c["start_defocus"] * f, c["end_defocus"] * f
    ga = _spacing(c["start_amp"], c["end_amp"], c["n_amp"])
    gp = _spacing(sp, ep, c["n_defocus"])
    ge = _spacing(c["start_bfactor"], c["end_bfactor"], c["n_bfactor"])
    amps = np.float32(c["start_amp"]) + np.arange(c["n_amp"], dtype=np.float32) * np.float32(ga)
    phases = np.float32(sp) + np.arange(c["n_defocus"], dtype=np.float32) * np.float32(gp)
    envs = np.float32(c["start_bfactor"]) + np.arange(c["n_bfactor"], dtype=np.float32) * np.float32(ge)
    a, p, e = np.meshgrid(amps, phases, envs, indexing="ij")
    return CtfGrid(a.ravel(), p.ravel(), e.ravel(), float(ga), float(gp), float(ge),
                   pr["prior_defocus_center"] * f, pr["sigma_prior_defocus"] * f)


def ctf_bank(cfg: dict, grid: CtfGrid) -> np.ndarray:
    """(C, N, N/2+1) CTF kernels on the half spectrum, in float32 as the
    reference writes them (param.cpp:1536-1574): normalised by the DC value,
    with its row writes i and N-1-i (the later write wins)."""
    n, pix = cfg["n_pixels"], np.float32(cfg["pixel_size"])
    nf = n // 2 + 1
    i = np.arange(nf, dtype=np.float32)[:, None]
    j = np.arange(nf, dtype=np.float32)[None, :]
    radsq = (i * i + j * j) / np.float32(n) / np.float32(n) / pix / pix
    rows = np.zeros(n, np.int64)
    for k in range(nf):
        rows[k] = k
        rows[n - k - 1] = k
    out = np.empty((grid.amp.shape[0], n, nf), np.float32)
    two = np.float32(2.0)
    for k, (a, ph, en) in enumerate(zip(grid.amp, grid.phase, grid.env)):
        v = np.exp(-radsq * en / two) * (-a * np.cos(radsq * ph / two)
                                         - np.sqrt(np.float32(1.0) - a * a) * np.sin(radsq * ph / two))
        out[k] = (v / v[0, 0])[rows, :]
    return out


def displacements(cfg: dict) -> np.ndarray:
    """Signed displacements per axis in the reference's sweep order
    (bioem_algorithm.h:156-197)."""
    n, maxd, s = cfg["n_pixels"], cfg["max_displace_center"], cfg["grid_space_center"]
    pos = np.arange(0, maxd + 1, s)
    neg = np.arange(n - maxd, n, s) - n
    return np.concatenate([pos, neg]).astype(np.int64)


def log_norm_constant(cfg: dict, grid: CtfGrid, voluang: float) -> float:
    """0.5·log π + (1 − N²/2)(log 2π + 1) + log(volu), with the reference's
    volume element and its (2·maxD+1)·(2·maxD+2) quirk (param.cpp:1600-1607,
    bioem.cpp:1144-1149)."""
    pix, s, maxd = cfg["pixel_size"], cfg["grid_space_center"], cfg["max_displace_center"]
    pr = cfg["priors"]
    volu = (voluang * s * pix * s * pix / (2.0 * maxd + 1.0) / (2.0 * (maxd + 1.0))
            / float(cfg["ctf"]["n_amp"]) * grid.grid_env * grid.grid_phase / 4.0 / math.pi
            / math.sqrt(2.0 * math.pi) / pr["sigma_prior_bctf"] / grid.sigma_defocus
            / pr["sigma_prior_amp"])
    ntot = float(cfg["n_pixels"] ** 2)
    return 0.5 * math.log(math.pi) + (1.0 - ntot * 0.5) * (math.log(2.0 * math.pi) + 1.0) + math.log(volu)


def ctf_prior(cfg: dict, grid: CtfGrid) -> np.ndarray:
    """(C,) term subtracted from logpro, with the reference's sign quirk
    (bioem_algorithm.h:49-67)."""
    pr = cfg["priors"]
    env, pha, amp = (x.astype(np.float64) for x in (grid.env, grid.phase, grid.amp))
    return (env * env / 2.0 / pr["sigma_prior_bctf"] ** 2
            - (pha - grid.prior_defocus_center) ** 2 / 2.0 / grid.sigma_defocus ** 2
            - (amp - pr["prior_amp_center"]) ** 2 / 2.0 / pr["sigma_prior_amp"] ** 2)


# ---------------------------------------------------------------------------
# Projection (bioem.cpp:1627-1818)
# ---------------------------------------------------------------------------

def rotation_f32(q: torch.Tensor) -> torch.Tensor:
    """(O, 4) float32 quaternions → (O, 3, 3) float32 matrices, element by
    element as bioem.cpp:1638-1646 writes them; points rotate as R @ r."""
    q0, q1, q2, q3 = q.unbind(-1)
    rows = [[1 - 2 * q1 * q1 - 2 * q2 * q2, 2 * (q0 * q1 + q2 * q3), 2 * (q0 * q2 - q1 * q3)],
            [2 * (q0 * q1 - q2 * q3), 1 - 2 * q0 * q0 - 2 * q2 * q2, 2 * (q1 * q2 + q0 * q3)],
            [2 * (q0 * q2 + q1 * q3), 2 * (q1 * q2 - q0 * q3), 1 - 2 * q0 * q0 - 2 * q1 * q1]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


@dataclass
class VoxelModel:
    points: np.ndarray  # (P, 3) float32, centred on the density mass
    radii: np.ndarray  # (P,) float32, all 2·pix
    densities: np.ndarray  # (P,) float32, the voxels' values
    norm_den: float


def _axis(n: int, pix: float) -> np.ndarray:
    """BioEM's coordinates of 1-based voxel indices along one axis, float64
    then float32: (idx − n/2)·pix."""
    return ((np.arange(1, n + 1) - n / 2.0) * pix).astype(np.float32)


def _model_seed(model) -> int:
    h = hashlib.sha256()
    for a in (model.points, model.densities):
        h.update(np.ascontiguousarray(a).tobytes())
    return int.from_bytes(h.digest()[:8], "little")


def voxel_map(cfg: dict, model) -> np.ndarray:
    """The (box, box, box) float32 density map of a residue model, indexed
    [i − 1, j − 1, k − 1] (the file order BioEM reads): every residue a
    Gaussian of its electron count (its density) with σ = ``sigma_A``,
    integrated over the voxel's volume, plus N(0, ``noise_rel`` × the
    noise-free map's largest value) on every voxel."""
    spec = cfg["map"]
    nb, pix, sigma = spec["box"], float(cfg["pixel_size"]), float(spec["sigma_A"])
    ax = _axis(nb, pix).astype(np.float64)
    reach = int(math.ceil(spec["cutoff_sigma"] * sigma / pix))
    norm = pix ** 3 / (2.0 * math.pi * sigma * sigma) ** 1.5
    flat = np.zeros(nb * nb * nb, np.float64)
    off = np.arange(-reach, reach + 1)
    for c, d in zip(np.asarray(model.points, np.float64), np.asarray(model.densities, np.float64)):
        # the voxel nearest the residue on each axis (index of ax), and its box
        near = np.rint(c / pix + nb / 2.0 - 1.0).astype(np.int64)
        idx = [np.clip(near[a] + off, 0, nb - 1) for a in range(3)]
        idx = [np.unique(i) for i in idx]
        g = [np.exp(-((ax[i] - c[a]) ** 2) / (2.0 * sigma * sigma)) for a, i in enumerate(idx)]
        val = d * norm * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
        lin = (idx[0][:, None, None] * nb + idx[1][None, :, None]) * nb + idx[2][None, None, :]
        np.add.at(flat, lin.ravel(), val.ravel())
    peak = float(flat.max())
    rng = np.random.default_rng(_model_seed(model))
    flat += rng.normal(0.0, spec["noise_rel"] * peak, flat.shape)
    return flat.astype(np.float32).reshape(nb, nb, nb)


_VOXELS: dict = {}


def voxel_model(cfg: dict, model) -> VoxelModel:
    """The model BioEM reads from :func:`voxel_map`'s map (model.cpp:332-416),
    centred on its density mass in float32 (model.cpp:604-672); made once
    per (configuration, model) and kept."""
    spec = cfg["map"]
    key = (spec["box"], cfg["pixel_size"], spec["sigma_A"], spec["noise_rel"],
           spec["cutoff_sigma"], _model_seed(model))
    if key not in _VOXELS:
        vol = voxel_map(cfg, model)
        nb, pix = spec["box"], cfg["pixel_size"]
        pts = np.empty((nb, nb, nb, 3), np.float32)
        for a in range(3):
            shape = [1, 1, 1]
            shape[a] = nb
            pts[..., a] = _axis(nb, pix).reshape(shape)
        pts = pts.reshape(-1, 3)
        dens = vol.reshape(-1).astype(np.float32)
        norm_den = float(dens.astype(np.float64).sum())
        cm = (pts * dens[:, None]).sum(axis=0) / np.float32(norm_den)
        radii = np.full(dens.shape, 2.0 * pix, np.float32)
        _VOXELS.clear()
        _VOXELS[key] = VoxelModel((pts - cm).astype(np.float32), radii, dens, norm_den)
    return _VOXELS[key]


def project(cfg: dict, quats: torch.Tensor, model, device) -> torch.Tensor:
    """(O, N, N/2+1) complex128 spectra of the projections at ``quats``
    (O, 4) of the voxel model of ``model`` (a residue model:
    :func:`voxel_model`): the rotation and the snap in float32, each
    voxel's disc (its nonzero chord-length weights) deposited in float64,
    the total renormalised to the model's density, then the 2-D real FFT.
    Every voxel has one radius, so its weight at disc offset e is its
    density times the unit chord length c_e: the deposit is the in-frame
    densities summed at each voxel's pixel, then that image shifted by each
    offset and summed with weight c_e."""
    vm = voxel_model(cfg, model)
    n, pix = cfg["n_pixels"], cfg["pixel_size"]
    inv_pix = float(np.float32(1.0) / np.float32(pix))
    radius = float(vm.radii[0])
    assert bool((vm.radii == vm.radii[0]).all()) and radius > float(np.float32(pix))
    irad = int(np.float32(radius) * np.float32(inv_pix)) + 1
    # the disc: offsets with d² < r², and their unit chord lengths
    du = np.arange(-irad, irad + 1)
    d2 = (du[:, None] ** 2 + du[None, :] ** 2).astype(np.float64) * (pix * pix)
    disc = [(int(a), int(b), pix * pix * 2.0 * math.sqrt(radius * radius - d2[i, j]) * 3.0
             / (4.0 * math.pi * radius ** 3))
            for i, a in enumerate(du) for j, b in enumerate(du) if d2[i, j] < radius * radius]
    n_o, n_p = quats.shape[0], vm.points.shape[0]
    rot = rotation_f32(quats.to(device=device, dtype=F32)).double()
    half = float(n) / 2.0
    sx, sy = cfg.get("shift_x", 0), cfg.get("shift_y", 0)
    step = max(1, (1 << 24) // n_p)  # orientations a chunk
    p_step = min(n_p, 1 << 24)  # points a chunk
    centre = torch.zeros(n_o * n * n, dtype=F64, device=device)
    for p0 in range(0, n_p, p_step):
        pts = torch.as_tensor(vm.points[p0:p0 + p_step], device=device).double()
        dens = torch.as_tensor(vm.densities[p0:p0 + p_step], device=device).double()
        for o0 in range(0, n_o, step):
            r = rot[o0:o0 + step]

            def coordinate(k):
                # BioEM's float loop contracted to fused multiply-adds
                # (bioem_posterior.project)
                t = (r[:, k, 0, None] * pts[None, :, 0]).float()
                t = (r[:, k, 1, None] * pts[None, :, 1] + t.double()).float()
                return (r[:, k, 2, None] * pts[None, :, 2] + t.double()).float()

            i0 = torch.floor(coordinate(0) * inv_pix + half + 0.5).long() - sx
            j0 = torch.floor(coordinate(1) * inv_pix + half + 0.5).long() - sy
            valid = (i0 >= irad) & (j0 >= irad) & (i0 < n - irad) & (j0 < n - irad)
            b, p = torch.nonzero(valid, as_tuple=True)
            centre.index_add_(0, (b + o0) * (n * n) + i0[b, p] * n + j0[b, p], dens[p])
            del i0, j0, valid, b, p
    centre = centre.reshape(n_o, n, n)
    img = torch.zeros_like(centre)
    for a, b, c in disc:
        # the disc's offset (a, b): every pixel's centre sum, moved by it
        img[:, max(a, 0):n + min(a, 0), max(b, 0):n + min(b, 0)] += (
            c * centre[:, max(-a, 0):n - max(a, 0), max(-b, 0):n - max(b, 0)])
    tempden = centre.sum(dim=(1, 2)) * sum(c for _a, _b, c in disc)
    img = img * (float(vm.norm_den) / tempden)[:, None, None]
    return torch.fft.rfft2(img)


# ---------------------------------------------------------------------------
# The posterior (bioem.cpp:659-907, bioem_algorithm.h:18-198)
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10-bit mantissa."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(F32)


def _cmatmul_tf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A complex contraction as four real ones on TF32-rounded float32
    operands with float32 sums; the result as complex128."""
    ar, ai = _tf32(a.real.float()), _tf32(a.imag.float())
    br, bi = _tf32(b.real.float()), _tf32(b.imag.float())
    re = torch.einsum(eq, ar, br) - torch.einsum(eq, ai, bi)
    im = torch.einsum(eq, ar, bi) + torch.einsum(eq, ai, br)
    return torch.complex(re.double(), im.double())


class Posterior:
    """The reference's posterior for a set of images of one problem.

    ``images`` (I, N, N) float32 are the images to judge; ``models`` the
    problem's models (each with points, radii, densities, norm_den);
    ``quats`` (O, 4) and ``voluang`` its orientations. :meth:`run` gives,
    for one model, each image's log-posterior, its best log-probability
    and the tuple (orientation, CTF, x index, y index) where it lies, and
    the log-probability at any tuples asked for (``queries``)."""

    def __init__(self, cfg: dict, quats: np.ndarray, voluang: float, images: np.ndarray,
                 device, precision: str = "f64", block_elems: int = 4096):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"precision must be f64 or tf32, got {precision}")
        self.cfg, self.device, self.precision = cfg, torch.device(device), precision
        n = cfg["n_pixels"]
        nf = n // 2 + 1
        self.n = n
        self.grid = ctf_grid(cfg)
        self.ctf = torch.as_tensor(ctf_bank(cfg, self.grid), device=self.device).to(C128)
        self.prior = torch.as_tensor(ctf_prior(cfg, self.grid), device=self.device)
        self.k_norm = log_norm_constant(cfg, self.grid, voluang)
        self.disp = displacements(cfg)
        d = torch.as_tensor(self.disp, dtype=F64, device=self.device)
        two_pi_n = 2.0 * math.pi / n
        self.wx = torch.exp(1j * two_pi_n * d[:, None] * torch.arange(n, dtype=F64, device=self.device))
        self.wy = torch.exp(1j * two_pi_n * d[:, None] * torch.arange(nf, dtype=F64, device=self.device))
        h = torch.full((nf,), 2.0, dtype=F64, device=self.device)
        h[0] = 1.0
        if n % 2 == 0:
            h[-1] = 1.0
        self.h = h
        maps = torch.as_tensor(images, device=self.device).to(F64)
        flat = maps.reshape(maps.shape[0], -1)
        # stored as float by the reference (map.cpp)
        self.sum_ref = flat.sum(1).float().double()
        self.ssq_ref = (flat * flat).sum(1).float().double()
        self.img = torch.conj(torch.fft.rfft2(maps)) * (h / (n * n))
        self.quats = torch.as_tensor(np.asarray(quats, np.float32), device=self.device)
        self.n_img = maps.shape[0]
        c = self.ctf.shape[0]
        self.o_block = max(1, block_elems // (c * self.n_img))

    def _contract(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "f64":
            return torch.einsum(eq, a, b)
        return _cmatmul_tf32(eq, a, b)

    def logpro(self, proj: torch.Tensor) -> torch.Tensor:
        """(O, C, I, Dx, Dy) float64 log-probabilities of a block of
        projection spectra (O, N, F)."""
        n = self.n
        ntot = float(n * n)
        conv = proj[:, None] * torch.conj(self.ctf)[None]  # (O, C, N, F)
        s = conv[..., 0, 0].real
        ss = (self.h * (conv.real ** 2 + conv.imag ** 2)).sum((-2, -1)) / ntot
        prod = conv[:, :, None] * self.img[None, None]  # (O, C, I, N, F)
        t = self._contract("dk,ocikf->ocidf", self.wx, prod)
        del prod
        cc = self._contract("ocidf,ef->ocide", t, self.wy).real
        s = s[:, :, None, None, None]
        ss = ss[:, :, None, None, None]
        sr = self.sum_ref[None, None, :, None, None]
        ssr = self.ssq_ref[None, None, :, None, None]
        forlog = ss * ntot - s * s
        first = ntot * (ssr * ss - cc * cc) + 2 * sr * s * cc - ssr * s * s - sr * sr * ss
        lp = ((3 - ntot) * 0.5 * torch.log(first) + (ntot * 0.5 - 2) * torch.log((ntot - 2) * forlog)
              - self.prior[None, :, None, None, None])
        return lp

    def run(self, model, queries=None) -> dict:
        """The posterior of ``model`` for every image. ``queries`` is an
        (Q, 5) integer array of (image, orientation, CTF, x index, y index);
        ``query_lp`` gives the log-probability at each."""
        dev = self.device
        n_o, n_i = self.quats.shape[0], self.n_img
        run_max = torch.full((n_i,), -math.inf, dtype=F64, device=dev)
        run_sum = torch.zeros(n_i, dtype=F64, device=dev)
        best = torch.zeros((n_i, 4), dtype=torch.long, device=dev)
        q = torch.as_tensor(np.zeros((0, 5)) if queries is None else queries,
                            dtype=torch.long, device=dev).reshape(-1, 5)
        q_lp = torch.full((q.shape[0],), math.nan, dtype=F64, device=dev)
        for o0 in range(0, n_o, self.o_block):
            o1 = min(o0 + self.o_block, n_o)
            lp = self.logpro(project(self.cfg, self.quats[o0:o1], model, dev))
            nb, nc, _, nd, _ = lp.shape
            per_img = lp.permute(2, 0, 1, 3, 4).reshape(n_i, -1)
            m, arg = per_img.max(1)
            new_max = torch.maximum(run_max, m)
            run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(per_img - new_max[:, None]).sum(1)
            took = m > run_max
            o, rest = arg // (nc * nd * nd), arg % (nc * nd * nd)
            tup = torch.stack([o + o0, rest // (nd * nd), (rest // nd) % nd, rest % nd], 1)
            best = torch.where(took[:, None], tup, best)
            run_max = new_max
            sel = (q[:, 1] >= o0) & (q[:, 1] < o1)
            if bool(sel.any()):
                qs = q[sel]
                q_lp[sel] = lp[qs[:, 1] - o0, qs[:, 2], qs[:, 0], qs[:, 3], qs[:, 4]]
        log_prob = torch.log(run_sum) + run_max + self.k_norm
        return {"log_prob": log_prob.cpu().numpy(), "best_lp": run_max.cpu().numpy(),
                "best": best.cpu().numpy(), "query_lp": q_lp.cpu().numpy()}
