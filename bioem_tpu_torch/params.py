"""Physics-parameter parsing and derived integration grids (NumPy host layer).

A copy of ``bioem_tpu.params``: the JAX package imports JAX at package
import time, so the PyTorch port carries its own jax-free host modules.

Re-implementation of the reference's keyword parameter file
(reference: param.cpp:64-627) and the derived quantities
computed in ``CalculateRefCTF`` (param.cpp:1336-1620): CTF/PSF grid values,
the displacement grid, and the normalised integration volume element.

The parser accepts exactly the reference keyword set so existing BioEM input
files work unchanged. All reference numerical quirks that affect log(P) are
reproduced deliberately (and documented inline), because golden-value parity
with ``Output_Probabilities`` requires them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

DEFAULT_ELECTRON_WAVELENGTH = 0.019866  # reference param.cpp:86


class ParamError(ValueError):
    """Raised for invalid or missing parameter input (reference myError)."""


@dataclass
class BioEMParams:
    """Physics parameters (reference ``bioem_param``, param.h + param.cpp).

    Only physics parameters live here; performance knobs (block sizes, mesh
    shape) live in :class:`bioem_tpu_torch.config.RunConfig` — mirroring the
    reference's deliberate split between the keyword file (changes results)
    and environment variables (never change results), doc/index.rst:526-535.
    """

    # Mandatory
    pixel_size: float = 0.0
    n_pixels: int = 0

    # Euler-angle grid (uniform)
    grid_points_alpha: int = 0
    grid_points_beta: int = 0

    # Quaternions
    use_quaternions: bool = False
    grid_points_quaternion: int = -1

    # Orientation list from file (--ReadOrientation)
    not_uniform_angles: bool = False
    prior_angles: bool = False  # PRIOR_ANGLES keyword

    # CTF grids (Fourier-space mode, default)
    start_bfactor: float = 0.0
    end_bfactor: float = 0.0
    n_env: int = 0
    start_defocus: float = 0.0
    end_defocus: float = 0.0
    n_phase: int = 0
    start_amp: float = 0.0
    end_amp: float = 0.0
    n_amp: int = 0
    electron_wavelength: float = DEFAULT_ELECTRON_WAVELENGTH

    # PSF grids (real-space mode)
    use_psf: bool = False
    start_env: float = 0.0  # PSF_ENVELOPE start (shared storage with bfactor)
    end_env: float = 0.0
    start_phase: float = 0.0  # PSF_PHASE start (radians-space phase)
    end_phase: float = 0.0

    # Center displacement
    max_displace_center: int = 0
    grid_space_center: int = 1

    # Behaviour switches
    write_angles: int = 0  # WRITE_PROB_ANGLES top-K count
    ignore_pdb: bool = False
    project_radius: bool = True  # NO_PROJECT_RADIUS clears this
    write_ctf_param: bool = False
    no_center_mass: bool = False
    print_rotated_models: bool = False
    no_map_norm: bool = False
    prior_model: float = 1.0
    shift_x: int = 0
    shift_y: int = 0

    # Gaussian priors on CTF parameters (reference param.cpp:102-106 defaults)
    sigma_prior_bctf: float = 100.0
    sigma_prior_defocus: float = 2.0
    prior_defocus_center: float = 3.0
    sigma_prior_amp: float = 0.5
    prior_amp_center: float = 0.0

    def __post_init__(self):
        self._finalized = False

    # ---- derived quantities (filled by finalize()) ----
    @property
    def n_fft_1d(self) -> int:
        """NumberFFTPixels1D = N/2 + 1 (reference param.cpp:614)."""
        return self.n_pixels // 2 + 1

    @property
    def n_total_pixels(self) -> float:
        """Ntotpi = N² as float (reference param.cpp:1612)."""
        return float(self.n_pixels * self.n_pixels)

    @property
    def n_ctf(self) -> int:
        """Total CTF/PSF kernels = nAmp × nPhase × nEnv (param.cpp:1356)."""
        return self.n_amp * self.n_phase * self.n_env

    @property
    def nx_disp(self) -> int:
        """Displacements per axis = 2·(maxD // step) + 1 (param.cpp:1614)."""
        return 2 * (self.max_displace_center // self.grid_space_center) + 1

    @property
    def n_total_disp(self) -> int:
        return self.nx_disp * self.nx_disp

    def finalize_ctf_mode(self) -> "BioEMParams":
        """Apply the CTF→phase-space conversions done at parse time.

        Reference param.cpp:600-607: in CTF mode the defocus grid (µm) is
        converted to a phase grid ``phase = defocus · 2π · 10⁴ · λ`` and the
        defocus prior centre/width are scaled by the same factor. PSF mode
        keeps user values as-is.
        """
        if self._finalized:
            return self
        p = self
        if not p.use_psf:
            f = math.pi * 2.0 * 10000.0 * p.electron_wavelength
            p = replace(
                p,
                start_phase=p.start_defocus * f,
                end_phase=p.end_defocus * f,
                start_env=p.start_bfactor,
                end_env=p.end_bfactor,
                prior_defocus_center=p.prior_defocus_center * f,
                sigma_prior_defocus=p.sigma_prior_defocus * f,
            )
        p._finalized = True
        return p


@dataclass
class CTFGrid:
    """CTF/PSF parameter grid values + spacings (param.cpp:1365-1396).

    The spacings feed the integration volume element. Reference quirks kept:
    - spacing = (end − start)/n  (n, not n−1: endpoint excluded)
    - when n == 1, the *spacing variable* is set to the start value itself
      and reused as the volume element factor (param.cpp:1373-1396).
    """

    amp: np.ndarray  # (n_ctf,) flattened in (amp, phase, env) C order
    phase: np.ndarray
    env: np.ndarray
    grid_amp: float
    grid_phase: float
    grid_env: float

    @property
    def n(self) -> int:
        return self.amp.shape[0]


def make_ctf_grid(p: BioEMParams) -> CTFGrid:
    """Build the flattened (amp × phase × env) parameter tuples.

    Loop order matches reference param.cpp:1423-1583 (amp outer, phase,
    env inner), which fixes the meaning of the argmax ``iConv`` index.
    """
    ga = (p.end_amp - p.start_amp) / p.n_amp
    gp = (p.end_phase - p.start_phase) / p.n_phase
    ge = (p.end_env - p.start_env) / p.n_env
    if p.n_amp == 1:
        ga = p.start_amp
    elif p.end_amp - p.start_amp < 0:
        raise ParamError("Interval of amplitude in CTF/PSF negative")
    if p.n_phase == 1:
        gp = p.start_phase
    elif p.end_phase - p.start_phase < 0:
        raise ParamError("Interval of phase in CTF/PSF is negative")
    if p.n_env == 1:
        ge = p.start_env
    elif p.end_env - p.start_env < 0:
        raise ParamError("Interval of envelope in CTF/PSF is negative")

    # Grid values: start + i·spacing, i = 0..n-1. When n == 1 the spacing
    # equals the start value but i == 0 so value == start. (param.cpp:1426-1436)
    amps = np.float32(p.start_amp) + np.arange(p.n_amp, dtype=np.float32) * np.float32(ga)
    phases = np.float32(p.start_phase) + np.arange(p.n_phase, dtype=np.float32) * np.float32(gp)
    envs = np.float32(p.start_env) + np.arange(p.n_env, dtype=np.float32) * np.float32(ge)

    A, P_, E = np.meshgrid(amps, phases, envs, indexing="ij")
    return CTFGrid(
        amp=A.ravel().astype(np.float32),
        phase=P_.ravel().astype(np.float32),
        env=E.ravel().astype(np.float32),
        grid_amp=float(ga),
        grid_phase=float(gp),
        grid_env=float(ge),
    )


def displacement_lists(p: BioEMParams) -> tuple[np.ndarray, np.ndarray]:
    """Displacement values per axis in the reference's sweep order.

    Reference bioem_algorithm.h:156-197 enumerates wrapped positions
    cent ∈ {0, s, …, maxD} then {N−maxD, …, N−1 step s}; the signed
    displacement is cent (first range) or cent − N (second). Keeping this
    exact order makes vectorised argmax tie-breaking match the reference's
    sequential strict-``>`` update.

    Returns (disp, cent): signed displacements and wrapped grid positions.
    """
    s = p.grid_space_center
    maxd = p.max_displace_center
    n = p.n_pixels
    pos = np.arange(0, maxd + 1, s, dtype=np.int32)
    neg_cent = np.arange(n - maxd, n, s, dtype=np.int32)
    cent = np.concatenate([pos, neg_cent])
    disp = np.concatenate([pos, neg_cent - n]).astype(np.int32)
    return disp, cent


def orientation_volume_quirked(p: BioEMParams, voluang: float, ctf: CTFGrid) -> float:
    """Integration volume element ``param_device.volu``.

    Copied exactly from reference param.cpp:1600-1607 including the
    asymmetric displacement normalisation (2·maxD+1)·(2·(maxD+1)) — the
    second factor is 2·maxD+2 in the reference source, a quirk preserved
    for golden parity.
    """
    return (
        voluang
        * float(p.grid_space_center) * p.pixel_size
        * float(p.grid_space_center) * p.pixel_size
        / (2.0 * p.max_displace_center + 1.0)
        / (2.0 * (p.max_displace_center + 1.0))
        / float(p.n_amp)
        * ctf.grid_env
        * ctf.grid_phase
        / 4.0
        / math.pi
        / math.sqrt(2.0 * math.pi)
        / p.sigma_prior_bctf
        / p.sigma_prior_defocus
        / p.sigma_prior_amp
    )


def log_normalization_constant(p: BioEMParams, volu: float) -> float:
    """Constant added to log(Total)+Const for the final log posterior.

    Reference bioem.cpp:1144-1149:
    0.5·log(π) + (1 − N²/2)·(log(2π) + 1) + log(volu).
    """
    ntot = p.n_total_pixels
    return 0.5 * math.log(math.pi) + (1.0 - ntot * 0.5) * (math.log(2.0 * math.pi) + 1.0) + math.log(volu)


# ---------------------------------------------------------------------------
# Keyword-file parser
# ---------------------------------------------------------------------------

def read_parameters(path: str, not_uniform_angles: bool = False) -> BioEMParams:
    """Parse a BioEM keyword parameter file (reference param.cpp:64-627).

    ``not_uniform_angles`` is set when the CLI passed --ReadOrientation
    (orientations come from a file rather than a uniform grid).
    """
    p = BioEMParams(not_uniform_angles=not_uniform_angles)
    seen = set()

    with open(path, "r") as f:
        lines = f.readlines()

    for line in lines:
        if line.startswith("#"):
            continue
        tok = line.split()
        if not tok:
            continue
        key, args = tok[0], tok[1:]

        def farg(i=0):
            return float(args[i])

        def iarg(i=0):
            return int(args[i])

        if key == "PIXEL_SIZE":
            p.pixel_size = farg()
            if p.pixel_size < 0:
                raise ParamError("Negative pixel size")
            seen.add("pix")
        elif key == "NUMBER_PIXELS":
            p.n_pixels = iarg()
            if p.n_pixels < 0:
                raise ParamError("Negative Number of Pixels")
            seen.add("npix")
        elif key == "GRIDPOINTS_ALPHA":
            p.grid_points_alpha = iarg()
            if p.grid_points_alpha < 0:
                raise ParamError("Negative GRIDPOINTS_ALPHA")
            seen.add("gal")
        elif key == "GRIDPOINTS_BETA":
            p.grid_points_beta = iarg()
            if p.grid_points_beta < 0:
                raise ParamError("Negative GRIDPOINTS_BETA")
            seen.add("gbe")
        elif key == "USE_QUATERNIONS":
            p.use_quaternions = True
        elif key == "GRIDPOINTS_QUATERNION":
            if not_uniform_angles:
                raise ParamError("Inconsistent input: grid or list with quaternions?")
            p.grid_points_quaternion = iarg()
            p.use_quaternions = True
            seen.add("quatgrid")
        elif key == "CTF_B_ENV":
            p.start_bfactor, p.end_bfactor = farg(0), farg(1)
            p.n_env = iarg(2)
            if p.start_bfactor < 0 or p.end_bfactor < 0 or p.n_env < 0:
                raise ParamError("Negative CTF_B_ENV input")
            if p.start_bfactor > p.end_bfactor:
                raise ParamError("Grid ill defined end > start")
            seen.add("bfact")
        elif key == "CTF_DEFOCUS":
            p.start_defocus, p.end_defocus = farg(0), farg(1)
            p.n_phase = iarg(2)
            if p.start_defocus < 0 or p.end_defocus < 0 or p.n_phase < 0:
                raise ParamError("Negative CTF_DEFOCUS input")
            if p.start_defocus > p.end_defocus:
                raise ParamError("Grid ill defined end > start")
            if p.end_defocus > 8.0:
                raise ParamError("Defocus beyond 8micro-m range is not allowed")
            seen.add("defocus")
        elif key == "CTF_AMPLITUDE":
            p.start_amp, p.end_amp = farg(0), farg(1)
            p.n_amp = iarg(2)
            if p.start_amp < 0 or p.end_amp < 0 or p.n_amp < 0:
                raise ParamError("Negative CTF_AMPLITUDE input")
            if p.start_amp > p.end_amp:
                raise ParamError("Grid ill defined end > start")
            seen.add("amp")
        elif key == "ELECTRON_WAVELENGTH":
            p.electron_wavelength = farg()
            if p.electron_wavelength < 0.0150:
                raise ParamError(
                    f"Wrong electron wave length {p.electron_wavelength}. Has to be in Angstrom (A)"
                )
        elif key == "USE_PSF":
            p.use_psf = True
        elif key == "PSF_AMPLITUDE":
            p.start_amp, p.end_amp = farg(0), farg(1)
            p.n_amp = iarg(2)
            if p.start_amp > p.end_amp:
                raise ParamError("Grid ill defined end > start")
            seen.add("amp")
        elif key == "PSF_ENVELOPE":
            p.start_env, p.end_env = farg(0), farg(1)
            p.n_env = iarg(2)
            if p.start_env > p.end_env:
                raise ParamError("Grid ill defined end > start")
            seen.add("psfenv")
        elif key == "PSF_PHASE":
            p.start_phase, p.end_phase = farg(0), farg(1)
            p.n_phase = iarg(2)
            if p.start_phase > p.end_phase:
                raise ParamError("Grid ill defined end > start")
            seen.add("psfpha")
        elif key == "DISPLACE_CENTER":
            p.max_displace_center = iarg(0)
            p.grid_space_center = iarg(1)
            if p.max_displace_center < 0:
                raise ParamError("Negative MAX_D_CENTER")
            if p.grid_space_center < 0:
                raise ParamError("Negative PIXEL_GRID_CENTER")
            seen.add("mdc")
        elif key == "WRITE_PROB_ANGLES":
            p.write_angles = iarg()
            if p.write_angles < 0:
                raise ParamError("Negative WRITE_PROB_ANGLES")
        elif key == "IGNORE_PDB":
            p.ignore_pdb = True
        elif key == "NO_PROJECT_RADIUS":
            p.project_radius = False
        elif key == "WRITE_CTF_PARAM":
            p.write_ctf_param = True
        elif key == "NO_CENTEROFMASS":
            p.no_center_mass = True
        elif key == "PRINT_ROTATED_MODELS":
            p.print_rotated_models = True
        elif key == "NO_MAP_NORM":
            p.no_map_norm = True
        elif key == "PRIOR_MODEL":
            p.prior_model = farg()
        elif key == "PRIOR_ANGLES":
            p.prior_angles = True
        elif key == "SHIFT_X":
            p.shift_x = iarg()
        elif key == "SHIFT_Y":
            p.shift_y = iarg()
        elif key == "SIGMA_PRIOR_B_CTF":
            p.sigma_prior_bctf = farg()
        elif key == "SIGMA_PRIOR_DEFOCUS":
            p.sigma_prior_defocus = farg()
        elif key == "PRIOR_DEFOCUS_CENTER":
            p.prior_defocus_center = farg()
        elif key == "SIGMA_PRIOR_AMP_CTF":
            p.sigma_prior_amp = farg()
        elif key == "PRIOR_AMP_CTF_CENTER":
            p.prior_amp_center = farg()
        # Unknown keywords are silently ignored, like the reference parser.

    # ---- validation (reference param.cpp:530-608) ----
    if "pix" not in seen:
        raise ParamError("Input missing: please provide PIXEL_SIZE")
    if "npix" not in seen:
        raise ParamError("Input missing: please provide NUMBER_PIXELS")
    if not not_uniform_angles:
        if not p.use_quaternions:
            if "gal" not in seen:
                raise ParamError("Input missing: please provide GRIDPOINTS_ALPHA")
            if "gbe" not in seen:
                raise ParamError("Input missing: please provide GRIDPOINTS_BETA")
        elif "quatgrid" not in seen:
            raise ParamError("Input missing: please provide GRIDPOINTS_QUATERNION")
    if "mdc" not in seen:
        raise ParamError("Input missing: please provide grid displacement CENTER")

    if p.use_psf:
        for k, msg in (("psfpha", "PSF PHASE"), ("psfenv", "PSF ENVELOPE"), ("amp", "PSF AMPLITUD")):
            if k not in seen:
                raise ParamError(f"Input missing: please provide grid {msg}")
    else:
        for k, msg in (("bfact", "CTF B Env."), ("defocus", "CTF defocus"), ("amp", "CTF amplitude")):
            if k not in seen:
                raise ParamError(f"Input missing: please provide grid {msg}")

    if p.write_ctf_param and not p.use_psf:
        raise ParamError("Writing CTF is only valid when integrating over the PSF")

    return p.finalize_ctf_mode()
