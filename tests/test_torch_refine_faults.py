"""The port's refinement with the CTF axes freed (--RefineCTF,
--RefineCTFAmp; tests/test_refine.py:226-307) against bioem_tpu.refine,
and the two refinement faults of the JAX package the port fixes, each
shown diverging from it:

* F2: at a grid amplitude of 1.0 with the amp axis gated off, the JAX
  gradient is NaN and no step is taken; the port holds a gated axis
  constant.
* F1: with the amplitude freed, a start driven to amp ≤ 0 makes the JAX
  objective NaN and wins its argmax; the port clamps amp at 1e-10 and
  masks non-finite finals.

Tolerances: test_torch_refine.py's (``_hold_to_jax``).
"""

import math

import numpy as np
import pytest
import torch

from bioem_tpu import refine as JR
from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.core.orientations import rotation_matrices as j_rotmats
from bioem_tpu_torch import refine as TR

import jax.numpy as jnp

from .conftest import tiny_images, tiny_model, tiny_params
from .test_refine import _params, _synth_image
from .test_torch_refine import _engines, _hold_to_jax
from .test_torch_refine import one_torch_thread  # noqa: F401  (autouse)


def _ctf_case(amp_shift=None):
    """tests/test_refine.py:226-307's CTF planting: an off-grid phase (or,
    with ``amp_shift``, an off-grid amplitude) at grid orientation 3."""
    rng = np.random.default_rng(1234)
    p = _params(n_phase=2, start_defocus=0.6, end_defocus=1.4)
    orients = j_orients(p)
    model = tiny_model(rng, n_points=10)
    boot = JEngine(p, orients, model, tiny_images(rng, 1, p.n_pixels), JConfig(orient_block=4))
    rot_star = np.asarray(j_rotmats(jnp.asarray(orients.angles[3]), orients.use_quaternions),
                          np.float64)
    b = boot.banks
    if amp_shift is None:
        pha_star = 0.5 * (float(b.pha[0]) + float(b.pha[1]))
        images = _synth_image(boot, rot_star, 0, np.zeros(2), rng, pha_star=pha_star)
        return p, model, images, pha_star
    amp_star = float(b.amp[0]) + amp_shift
    images = _synth_image(boot, rot_star, 0, np.zeros(2), rng, amp_star=amp_star)
    return p, model, images, amp_star


# The CTF variants refine with 4 starts and 20 iterations (the planted
# case above runs the defaults) to keep the module's JAX compiles and runs
# short; the parity contract is the same.
FAST = dict(n_starts=4, iters=20)


def test_refine_ctf_matches_jax():
    p, model, images, pha_star = _ctf_case()
    ej, rj, et, rt = _engines(p, model, images)
    c = dict(ej=ej, rj=rj, et=et, rt=rt, oj=JR.refine_results(ej, rj, refine_ctf=True, **FAST),
             ot=TR.refine_results(et, rt, refine_ctf=True, **FAST))
    _hold_to_jax(c)
    np.testing.assert_allclose(c["ot"].pha, c["oj"].pha, rtol=0, atol=1e-4)
    seed_pha = float(et.banks.pha[rt.best_conv[0]])
    assert abs(c["ot"].pha[0] - pha_star) < abs(seed_pha - pha_star)


def test_refine_ctf_amp_matches_jax():
    p, model, images, amp_star = _ctf_case(amp_shift=0.15)
    ej, rj, et, rt = _engines(p, model, images)
    amp_grid = float(et.banks.amp[0])
    pinned = TR.refine_results(et, rt, refine_ctf=True, **FAST)
    assert pinned.amp[0] == amp_grid  # default: the grid value passes through
    c = dict(ej=ej, rj=rj, et=et, rt=rt,
             oj=JR.refine_results(ej, rj, refine_ctf=True, refine_ctf_amp=True, **FAST),
             ot=TR.refine_results(et, rt, refine_ctf=True, refine_ctf_amp=True, **FAST))
    _hold_to_jax(c)
    np.testing.assert_allclose(c["ot"].amp, c["oj"].amp, rtol=0, atol=1e-4)
    assert abs(c["ot"].amp[0] - amp_star) < abs(amp_grid - amp_star)
    assert TR.AMP_FLOOR <= c["ot"].amp[0] <= TR.AMP_CEIL


# ---------------------------------------------------------------------------
# The faults fixed in the port
# ---------------------------------------------------------------------------

def test_f2_amp_one_grid_refines(rng):
    """F2: at a grid amplitude of 1.0, with the amp axis gated off (the
    default), the JAX objective keeps √(1−amp²) in its autodiff graph: its
    gradient is NaN, no Newton step is taken and grad_norm is NaN. The
    port holds a gated axis constant: finite gradients and a real step."""
    p = tiny_params(n_pixels=24, start_amp=1.0, end_amp=1.0)
    model = tiny_model(rng)
    images = tiny_images(rng, 2, p.n_pixels)
    ej, rj, et, rt = _engines(p, model, images)
    oj = JR.refine_results(ej, rj, iters=5, n_starts=2)
    ot = TR.refine_results(et, rt, iters=5, n_starts=2)
    assert np.all(np.isnan(oj.grad_norm))  # the JAX package's fault, shown
    assert np.all(np.isfinite(ot.grad_norm))
    assert np.all(ot.logpro_refined >= ot.logpro_seed)
    assert ot.logpro_refined[1] - ot.logpro_seed[1] > 1e-6
    np.testing.assert_allclose(ot.logpro_seed, oj.logpro_seed, rtol=1e-6)
    assert np.all(ot.amp == 1.0)


def test_f1_amp_floor_keeps_the_winner_finite(rng):
    """F1: with the amplitude freed, a start driven to amp ≤ 0 makes the
    JAX objective NaN (its DC normalisation divides by −amp = 0) and
    jnp.argmax picks that NaN start. The port clamps amp at 1e-10 (the
    grid engine's floor) and masks non-finite finals: finite objective,
    finite winner."""
    p = tiny_params(n_pixels=24, start_amp=0.01, end_amp=0.01)
    model = tiny_model(rng)
    images = tiny_images(rng, 2, p.n_pixels)
    ej, rj, et, rt = _engines(p, model, images)
    # the objective at amp driven to 0 (dctf[2] = −amp0)
    static_t = TR.refine_static(et, refine_ctf=True, refine_ctf_amp=True)
    bt = et.banks
    rot0 = torch.eye(3)
    ct = {"rot0": rot0, "amp0": bt.amp[0], "pha0": bt.pha[0], "env0": bt.env[0],
          "d0": torch.zeros(2, dtype=torch.float64), "img_re": bt.img_re[0],
          "img_im": bt.img_im[0], "sum_ref": bt.sum_ref[0], "ssq_ref": bt.ssq_ref[0]}
    th = {"omega": torch.zeros(3, dtype=torch.float64), "d": torch.zeros(2, dtype=torch.float64),
          "dctf": torch.tensor([0.0, 0.0, -0.01], dtype=torch.float64)}
    assert math.isfinite(float(TR._logpro_smooth(th, ct, static_t)))
    # seed 0's starts: some take amp below 0
    rng0 = np.random.default_rng(0)
    rng0.normal(0.0, 0.12, (7, 3))
    rng0.uniform(-0.6, 0.6, (7, 2))
    assert np.any(0.01 + rng0.uniform(-0.05, 0.05, 7) <= 0.0)
    kw = dict(refine_ctf=True, refine_ctf_amp=True, iters=3, n_starts=8)
    oj = JR.refine_results(ej, rj, **kw)
    ot = TR.refine_results(et, rt, **kw)
    assert np.all(np.isnan(oj.logpro_refined))  # the JAX package's fault, shown
    assert np.all(np.isfinite(ot.logpro_refined)) and np.all(np.isfinite(ot.grad_norm))
    assert np.all(ot.logpro_refined >= ot.logpro_seed)
    assert np.all(ot.amp >= TR.AMP_FLOOR)
