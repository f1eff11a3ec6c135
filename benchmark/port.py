"""The benchmark's one bridge to the program under test.

It turns a :class:`problem.Problem` into the program's own input types
(``BioEMParams``, ``OrientationSet``, ``Model``, ``ImageStack``) without
computing anything the program derives, and holds what every driver does
around a pass: the spans the traced run reads, the pass's host seconds and
the outputs the check judges. Only the drivers import it.
"""

from __future__ import annotations

import time

import numpy as np


def params(cfg: dict):
    """The configuration as the program's physics parameters."""
    from bioem_tpu_torch.params import BioEMParams

    c, pr = cfg["ctf"], cfg["priors"]
    return BioEMParams(
        pixel_size=cfg["pixel_size"], n_pixels=cfg["n_pixels"], use_quaternions=True,
        not_uniform_angles=True,
        n_amp=c["n_amp"], start_amp=c["start_amp"], end_amp=c["end_amp"],
        n_phase=c["n_defocus"], start_defocus=c["start_defocus"], end_defocus=c["end_defocus"],
        n_env=c["n_bfactor"], start_bfactor=c["start_bfactor"], end_bfactor=c["end_bfactor"],
        electron_wavelength=c["electron_wavelength"],
        max_displace_center=cfg["max_displace_center"], grid_space_center=cfg["grid_space_center"],
        shift_x=cfg.get("shift_x", 0), shift_y=cfg.get("shift_y", 0),
        sigma_prior_bctf=pr["sigma_prior_bctf"], sigma_prior_defocus=pr["sigma_prior_defocus"],
        prior_defocus_center=pr["prior_defocus_center"], sigma_prior_amp=pr["sigma_prior_amp"],
        prior_amp_center=pr["prior_amp_center"],
    ).finalize_ctf_mode()


def inputs(prob) -> tuple:
    """(params, orientations, models, images) in the program's types."""
    from bioem_tpu_torch.core.orientations import OrientationSet
    from bioem_tpu_torch.io.map_io import ImageStack
    from bioem_tpu_torch.io.model_io import Model

    orients = OrientationSet(angles=prob.quats, use_quaternions=True, voluang=prob.voluang)
    models = [Model(m.points, m.radii, m.densities, m.norm_den) for m in prob.models]
    return params(prob.cfg), orients, models, ImageStack(prob.images)


class Session:
    """A driver's running program: ``one_pass`` runs and records one pass
    (its host seconds into ``run.pass_s``, its outputs into ``outputs`` as
    (model index, log_prob, best (I, 4), best log-probability (I,)));
    ``close`` frees the card."""

    def __init__(self, run, device):
        import torch

        self.run = run
        self.device = torch.device(device)
        self.outputs = []
        self.eng = None

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def scored(self, model_index: int, banks=None, tag: str = "") -> float:
        """One pass of the engine on ``banks``, its results on the host;
        returns its host seconds."""
        from torch.autograd.profiler import record_function

        t0 = time.perf_counter()
        with record_function("bench.run"):
            state = self.eng.run(banks=banks, bank_tag=tag)
        with record_function("bench.sync"):
            self.sync()
        with record_function("bench.results"):
            res = self.eng.results(state)
        dt = time.perf_counter() - t0
        best = np.stack([res.best_orient, res.best_conv, res.best_cent_x, res.best_cent_y], 1)
        self.outputs.append((model_index, np.asarray(res.log_prob, np.float64), best.astype(np.int64),
                             np.asarray(res.constoadd, np.float64)))
        return dt

    def close(self):
        self.eng = None
