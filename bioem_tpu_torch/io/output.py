"""Output writers: Output_Probabilities and ANG_PROB files.

Byte-format-compatible with the reference writers
(reference bioem.cpp:1046-1374): same headers, same field order, same
fixed 4-decimal formatting (OUTPUT_PRECISION, defs.h:177), same unit
conversions (phase → defocus in µm for CTF mode, bioem.cpp:1199-1201).
"""

from __future__ import annotations

import math
from typing import TextIO

import numpy as np

from ..core.orientations import OrientationSet
from ..defs import OUTPUT_PRECISION
from ..params import BioEMParams, CTFGrid


def _f(v: float) -> str:
    """C++ ostream fixed-precision(4) float formatting."""
    return f"{v:.{OUTPUT_PRECISION}f}"


def write_probabilities(
    out: TextIO,
    p: BioEMParams,
    orients: OrientationSet,
    grid: CTFGrid,
    results,
) -> None:
    """Main results file (reference bioem.cpp:1077-1242)."""
    out.write(
        "************************* HEADER:: NOTATION "
        "*******************************************\n"
    )
    out.write(
        "Notation= RefMap:  MapNumber ; LogProb natural "
        "logarithm of posterior Probability ; Constant: "
        "Numerical Const. for adding Probabilities \n"
    )
    if not p.use_quaternions:
        if p.use_psf:
            out.write(
                "Notation= RefMap:  MapNumber ; Maximizing Param: "
                "MaxLogProb - alpha[rad] - beta[rad] - gamma[rad] - "
                "PSF amp - PSF phase - PSF envelope - center x - "
                "center y - normalization - offsett \n"
            )
        else:
            out.write(
                "Notation= RefMap:  MapNumber ; Maximizing Param: "
                "MaxLogProb - alpha[rad] - beta[rad] - gamma[rad] - "
                "CTF amp - CTF defocus - CTF B-Env - center x - "
                "center y - normalization - offsett \n"
            )
    else:
        if p.use_psf:
            out.write(
                "Notation= RefMap:  MapNumber ; Maximizing Param: "
                "MaxLogProb - q1 - q2 - q3 - q4 -PSF amp - PSF phase "
                "- PSF envelope - center x - center y - "
                "normalization - offsett \n"
            )
        else:
            out.write(
                "Notation= RefMap:  MapNumber ; Maximizing Param: "
                "MaxLogProb - q1 - q2 - q3 - q4 - CTF amp - CTF "
                "defocus - CTF B-Env - center x - center y - "
                "normalization - offsett \n"
            )
    if p.write_ctf_param:
        out.write(
            " RefMap:  MapNumber ; CTFMaxParm: defocus - b-Env (B "
            "ref. Penzeck 2010)\n"
        )
    if p.prior_angles:
        out.write("**** Remark: Using Prior Proability in Angles ****\n")
    out.write(
        "************************* HEADER:: NOTATION "
        "*******************************************\n\n"
    )

    n_img = results.log_prob.shape[0]
    for i in range(n_img):
        if results.total[i] > 1.0e-38:
            lp = results.log_prob[i]
            out.write(
                f"RefMap: {i} LogProb:  {_f(lp)} Constant: {_f(results.constoadd[i])}\n"
            )
            out.write(f"RefMap: {i} Maximizing Param: {_f(lp)} ")
        else:
            out.write(
                f"Warning - RefMap: {i}"
                "Numerical Integrated Probability without constant = 0.0;\n"
            )
            out.write(
                f"Warning - RefMap: {i}"
                f"Check that constant is finite: {_f(results.constoadd[i])}\n"
            )
            out.write(
                "Warning - RefMap: i) check model, ii) check refmap , "
                "iii) check GPU on/off command inconsitency\n"
            )

        io = int(results.best_orient[i])
        ic = int(results.best_conv[i])
        ang = orients.angles[io]
        out.write(f"{_f(ang[0])} [] ")
        out.write(f"{_f(ang[1])} [] ")
        out.write(f"{_f(ang[2])} [] ")
        if p.use_quaternions:
            out.write(f"{_f(ang[3])} [] ")
        out.write(f"{_f(grid.amp[ic])} [] ")
        if not p.use_psf:
            defocus = grid.phase[ic] / 2.0 / math.pi / p.electron_wavelength * 0.0001
            out.write(f"{_f(defocus)} [micro-m] ")
        else:
            out.write(f"{_f(grid.phase[ic])} [1/A²] ")
        if not p.use_psf:
            out.write(f"{_f(grid.env[ic])} [A²] ")
        else:
            out.write(f"{_f(grid.env[ic])} [1/A²] ")
        out.write(f"{int(results.best_cent_x[i])} [pix] ")
        out.write(f"{int(results.best_cent_y[i])} [pix] ")
        out.write(f"{_f(results.best_norm[i])} [] ")
        out.write(f"{_f(results.best_mu[i])} [] ")
        out.write("\n")

        if p.write_ctf_param and p.use_psf:
            # PSF → CTF parameter conversion (bioem.cpp:1225-1242)
            pha = float(grid.phase[ic])
            env = float(grid.env[ic])
            denom = pha * pha + env * env
            out.write(f"RefMap: {i} CTFMaxParam: ")
            out.write(
                f"{_f(2 * math.pi * pha / denom / p.electron_wavelength * 0.0001)} [micro-m] "
            )
            out.write(f"{_f(4 * math.pi**2 * env / denom)} [A²] \n")


def write_angle_probabilities(
    out: TextIO,
    p: BioEMParams,
    orients: OrientationSet,
    results,
) -> None:
    """Per-orientation posterior file ANG_PROB (reference bioem.cpp:1050-1075,
    1244-1365): top-K orientations per image, descending log-probability."""
    out.write(
        "************************* HEADER:: NOTATION "
        "*******************************************\n"
    )
    if not p.use_quaternions:
        out.write(
            " RefMap:  MapNumber ; alpha[rad] - beta[rad] - "
            "gamma[rad] - logP - cal log Probability + Constant: "
            "Numerical Const.+ log (volume) + prior ang\n"
        )
    else:
        out.write(
            " RefMap:  MapNumber ; q1 - q2 -q3 - logP- cal log "
            "Probability + Constant: Numerical Const. + log "
            "(volume) + prior ang\n"
        )
    out.write(
        "************************* HEADER:: NOTATION "
        "*******************************************\n"
    )

    angle_log = results.angle_log  # (I, n_orient), already includes k_norm
    k_norm = results.log_norm_const
    n_img, n_orient = angle_log.shape
    k = min(p.write_angles, n_orient)
    priors = orients.priors

    for i in range(n_img):
        logp = angle_log[i]
        # top-K descending; stable ordering for ties by orientation index
        order = np.argsort(-logp, kind="stable")[:k]
        for io in order:
            lp = logp[io]
            if p.prior_angles and priors is not None:
                lp = lp + priors[io]
            ang = orients.angles[io]
            # "Separated:" fields: log(forAngles), ConstAngle, k_norm
            # (reference bioem.cpp:1304-1324)
            lf, ca = results.angle_raw[0][i, io], results.angle_raw[1][i, io]
            out.write(f" {i} ")
            out.write(f"{_f(ang[0])} {_f(ang[1])} {_f(ang[2])} ")
            if p.use_quaternions:
                out.write(f"{_f(ang[3])} ")
            out.write(f"{_f(lp)} Separated: {_f(lf)} {_f(ca)} {_f(k_norm)}")
            if p.prior_angles and priors is not None:
                out.write(f" {_f(priors[io])}")
            out.write("\n")
