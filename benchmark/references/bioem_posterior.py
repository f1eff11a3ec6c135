"""Plain reference of the BioEM posterior, in PyTorch at float64.

The benchmark's own statement of what a pass computes, written from the
BioEM reference's formulas (bioem.cpp createProjection,
createConvolutedProjectionMap, calcProbability; bioem_algorithm.h
calc_logpro; param.cpp CalculateRefCTF) and from nothing of the program
under test. It imports no module of the program and takes nothing the
program made: it rebuilds the CTF bank, the image spectra, the
projections and the displacement lattice from the problem's inputs.

Where the BioEM reference itself computes in single precision, so does
this file, because those roundings are part of the result: the CTF values
(float, param.cpp), the rotation and the pixel snap (float, bioem.cpp), and
each image's sum and sum of squares (stored as float, map.cpp). The snap is
a step function of float32 values, so its order of roundings is fixed
here as the configuration's float32 states it: the rotated coordinate as
BioEM's loop contracted into fused multiply-adds in index order, x/pix as
x times the float reciprocal of pix (a one-ulp difference at a half-pixel
tie moves a point by a pixel, and the log-posterior by ~1). Everything
after the snap is float64: the stencil deposit, the spectra, the
cross-correlation over the lattice, the log-posterior and its sum.

``precision="tf32"`` is the control: the same computation with the two
contractions of the cross-correlation (over k1, then over k2) rounded as a
TF32 tensor core rounds them (each operand to a 10-bit mantissa, the sums
in float32), the step that a faster comparison kernel would take. The check
must find that control wrong.

Work is done in blocks of orientations, so the lattice tensors fit beside
whatever else the card holds.
"""

from __future__ import annotations

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


def project(cfg: dict, quats: torch.Tensor, model, device) -> torch.Tensor:
    """(O, N, N/2+1) complex128 spectra of the model's projections at
    ``quats`` (O, 4): the rotation and the snap in float32, each sphere's
    chord-length stencil deposited in float64, the total renormalised to
    the model's density, then the 2-D real FFT."""
    n, pix = cfg["n_pixels"], cfg["pixel_size"]
    pix32 = float(np.float32(pix))
    inv_pix = float(np.float32(1.0) / np.float32(pix))
    pts = torch.as_tensor(model.points, dtype=F32, device=device).double()
    radii = torch.as_tensor(model.radii, dtype=F32, device=device)
    dens = torch.as_tensor(model.densities, dtype=F64, device=device)
    rot = rotation_f32(quats.to(device=device, dtype=F32)).double()

    def coordinate(k):
        # BioEM's float loop pos[k] += R[k][j]·p[j] (j = 0, 1, 2) contracted
        # to fused multiply-adds: each product is exact in float64 and each
        # step rounds once to float32
        t = (rot[:, k, 0, None] * pts[None, :, 0]).float()
        t = (rot[:, k, 1, None] * pts[None, :, 1] + t.double()).float()
        return (rot[:, k, 2, None] * pts[None, :, 2] + t.double()).float()

    # x/pix as x times the float reciprocal of pix, then + N/2 and + 0.5,
    # each rounded to float32 (the order the configuration's float32 states)
    half = float(n) / 2.0
    i_raw = torch.floor(coordinate(0) * inv_pix + half + 0.5).long()
    j_raw = torch.floor(coordinate(1) * inv_pix + half + 0.5).long()
    small = radii <= pix32
    irad = (radii * inv_pix).long() + 1
    i0 = torch.where(small, i_raw, i_raw - cfg.get("shift_x", 0))
    j0 = torch.where(small, j_raw, j_raw - cfg.get("shift_y", 0))
    valid = torch.where(small, (i_raw >= 0) & (j_raw >= 0) & (i_raw < n) & (j_raw < n),
                        (i0 >= irad) & (j0 >= irad) & (i0 < n - irad) & (j0 < n - irad))
    s = int(irad[~small].max()) if bool((~small).any()) else 0
    du = torch.arange(-s, s + 1, device=device)
    d2 = (du[:, None] ** 2 + du[None, :] ** 2).double() * (pix * pix)  # (S, S)
    r = radii.double()[:, None, None]
    chord = (pix * pix * 2.0 * torch.sqrt(torch.clamp(r * r - d2, min=0.0)) * dens[:, None, None]
             * 3.0 / (4.0 * math.pi * r * r * r))
    w = torch.where(d2 < r * r, chord, torch.zeros((), dtype=F64, device=device))
    centre = (du[:, None] == 0) & (du[None, :] == 0)
    w = torch.where(small[:, None, None], torch.where(centre, dens[:, None, None], 0.0), w)
    w = w[None] * valid[..., None, None]  # (O, P, S, S)
    tempden = w.sum(dim=(1, 2, 3))
    flat = ((i0[..., None, None] + du[:, None]) * n + (j0[..., None, None] + du[None, :]))
    flat = flat.clamp(0, n * n - 1) + (torch.arange(quats.shape[0], device=device) * (n * n))[:, None, None, None]
    img = torch.zeros(quats.shape[0] * n * n, dtype=F64, device=device)
    img.index_add_(0, flat.reshape(-1), w.reshape(-1))
    img = img.reshape(-1, n, n) * (float(model.norm_den) / tempden)[:, None, None]
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
