"""The port's engine against bioem_tpu's BioEMEngine on the same inputs.

Plain branch (the port on the CPU) vs the JAX XLA path, and kernel branch
(``use_kernels=True``: on CPU tensors every kernel wrapper runs its plain
version) vs the JAX Pallas path in interpret mode; end to end and block
by block through convert.py on exactly the JAX engine's banks.

Tolerances. The JAX suite's own bound between its paths is logP rtol 1e-9 /
atol 1e-7 with the argmax tuple exact; it holds here for normalised images
(measured max |ΔlogP| 2.0e-7 at |logP| ≈ 375). Two comparisons exceed it
from a different f32 summation order and are held to 4× the measured
error instead: NO_MAP_NORM images, whose varying part is evaluated in f64
from f32 cc (measured 1.34e-6, asserted at 5.5e-6), and the kernel
branch's Fourier projection, whose exact twiddle table differs from the
JAX kernel's power-doubling phases (measured 2.6e-6, asserted at 1.1e-5);
per-angle logP 5.5e-7 (asserted at 2.2e-6). Every argmax tuple is exact.
"""

import numpy as np
import pytest
import torch

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu_torch.config import RunConfig as TConfig
from bioem_tpu_torch.convert import banks_from_numpy, state_from_numpy, state_to_numpy
from bioem_tpu_torch.core.engine import BioEMEngine as TEngine
from bioem_tpu_torch.core.orientations import build_orientations as t_orients

from .conftest import tiny_images, tiny_model, tiny_params

SUITE = dict(rtol=1e-9, atol=1e-7)
ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")


def _problem(rng, n_img=4, dc_offset=0.0, **pkw):
    p = tiny_params(**pkw)
    model = tiny_model(rng)
    images = tiny_images(rng, n_img, p.n_pixels)
    images.maps[:] += np.float32(dc_offset)
    return p, model, images


def _engines(p, model, images, jcfg, tcfg):
    ej = JEngine(p, j_orients(p), model, images, JConfig(**jcfg))
    et = TEngine(p, t_orients(p), model, images, TConfig(**tcfg), device="cpu")
    return ej, et


def _compare(rj, rt, logp_tol, ang_tol=None):
    np.testing.assert_allclose(rt.log_prob, rj.log_prob, **logp_tol)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)
    np.testing.assert_allclose(rt.best_norm, rj.best_norm, rtol=1e-5)
    np.testing.assert_allclose(rt.best_mu, rj.best_mu, rtol=1e-5, atol=1e-8)
    if ang_tol is not None:
        np.testing.assert_allclose(rt.angle_log, rj.angle_log, **ang_tol)


CASES = {
    # name: (params, n_img, dc offset, jax cfg, port cfg, logP tol, angle tol)
    "normalized": ({}, 4, 0.0, {}, {}, SUITE, None),
    "no_map_norm": (dict(no_map_norm=True), 4, 3.0, {}, {}, dict(rtol=0, atol=5.5e-6), None),
    "write_angles": (dict(write_angles=3), 4, 0.0, {}, {}, SUITE, dict(rtol=0, atol=2.2e-6)),
    "stride_fold": (dict(max_displace_center=4, grid_space_center=2), 4, 0.0, {}, {}, SUITE, None),
    "no_fold_n15": (dict(n_pixels=15, max_displace_center=5, grid_space_center=3), 2, 0.0,
                    dict(orient_block=3), dict(orient_block=3), SUITE, None),
    "padding": ({}, 5, 0.0, dict(orient_block=3, image_block=2),
                dict(orient_block=3, image_block=2), SUITE, None),
}
KCFG_J = dict(use_pallas=True, fused_lse=True, pallas_img_tile=2)
KCFG_T = dict(use_kernels=True, kernel_img_tile=2)
KERNEL_CASES = {
    "kernel_fourier": ({}, 4, 0.0, KCFG_J, KCFG_T, dict(rtol=0, atol=1.1e-5), None),
    "kernel_raster": ({}, 4, 0.0, {**KCFG_J, "projection": "raster"},
                      {**KCFG_T, "projection": "raster"}, SUITE, None),
    "kernel_no_map_norm": (dict(no_map_norm=True), 4, 3.0, KCFG_J, KCFG_T,
                           dict(rtol=0, atol=5.5e-6), None),
    "kernel_fold_pad_angles": (
        dict(max_displace_center=4, grid_space_center=2, write_angles=3), 5, 0.0,
        {**KCFG_J, "orient_block": 3}, {**KCFG_T, "orient_block": 3},
        dict(rtol=0, atol=1.1e-5), dict(rtol=0, atol=2.2e-5)),
}


@pytest.mark.parametrize("name", sorted(CASES) + sorted(KERNEL_CASES))
def test_engine_matches_jax(rng, name):
    pkw, n_img, dc, jcfg, tcfg, tol, ang_tol = {**CASES, **KERNEL_CASES}[name]
    p, model, images = _problem(rng, n_img, dc, **pkw)
    ej, et = _engines(p, model, images, {"orient_block": 2, **jcfg}, {"orient_block": 2, **tcfg})
    assert et.use_kernels == name.startswith("kernel")
    assert et._f32_corr_ok == ej._f32_corr_ok
    assert (et.n_img_pad, et.n_orient_pad) == (ej.n_img_pad, ej.n_orient_pad)
    _compare(ej.results(ej.run()), et.results(et.run()), tol, ang_tol)


@pytest.mark.parametrize("kernels", [False, True])
def test_block_step_on_jax_banks(rng, kernels):
    """The port's block step on exactly the JAX engine's banks and state
    (convert.py), block by block, to the JAX block step's state."""
    p, model, images = _problem(rng, 5, write_angles=3, max_displace_center=4,
                                grid_space_center=2)
    jcfg = {"orient_block": 3, **(KCFG_J if kernels else {})}
    tcfg = {"orient_block": 3, **(KCFG_T if kernels else {})}
    ej, et = _engines(p, model, images, jcfg, tcfg)
    banks = banks_from_numpy({k: np.asarray(v) for k, v in ej.banks._asdict().items()}, "cpu")
    for k, v in ej.banks._asdict().items():
        assert getattr(banks, k).numpy().dtype == np.asarray(v).dtype, k
    sj = ej.initial_state()
    st = state_from_numpy({k: (np.asarray(v) if v is not None else None)
                           for k, v in sj._asdict().items()}, "cpu")
    for b in range(ej.ang_blocks.shape[0]):
        sj = ej._step(sj, ej.banks, ej.ang_blocks[b], ej.offsets[b], ej.mask_blocks[b])
        st = et._block_step(st, banks, et.ang_blocks[b], b * et.o_block, et.mask_blocks[b])
    got = state_to_numpy(st)
    want = {k: (np.asarray(v) if v is not None else None) for k, v in sj._asdict().items()}
    # total and const trade off (total is relative to the running max), so
    # their meaningful combination log(total) + const is compared
    # the state's logP sits near −5 (no K normalisation yet), so the suite's
    # rtol gives no slack: measured 1.8e-7 (plain), asserted at 4×
    tol = dict(rtol=0, atol=1.1e-5 if kernels else 7.2e-7)
    for tot, con in (("total", "const"), ("ang_total", "ang_const")):
        with np.errstate(divide="ignore"):
            np.testing.assert_allclose(np.log(got[tot]) + got[con],
                                       np.log(want[tot]) + want[con], err_msg=tot, **tol)
    for k in ARGMAX:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("best_norm", "best_mu"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8, err_msg=k)


def test_run_bioem_end_to_end(rng, monkeypatch):
    """run_bioem of both packages: the public entry point, defaults (the
    port's on the CPU because BIOEM_TPU_FORCE_CPU asks for it)."""
    from bioem_tpu.run import run_bioem as j_run
    from bioem_tpu_torch.run import run_bioem as t_run

    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    p, model, images = _problem(rng, 3)
    rj, _ = j_run(p, j_orients(p), model, images, JConfig(autotune=False))
    rt, perf = t_run(p, t_orients(p), model, images, TConfig())
    assert perf["device"] == "cpu" and perf["comparisons"] == 8 * p.n_ctf * 3
    assert perf["engine"].device.type == "cpu"
    _compare(rj, rt, SUITE)
    assert rt.grid is not None


@pytest.mark.parametrize("kernels", [False, True])
def test_run_equals_the_block_loop(rng, kernels):
    """On the CPU run() is the eager loop: its state equals, bit for bit,
    the state of _block_step called block by block with int offsets, on a
    padded block with per-angle slabs."""
    from bioem_tpu_torch.core.posterior import PosteriorState

    p, model, images = _problem(rng, 5, write_angles=3, max_displace_center=4,
                                grid_space_center=2)
    cfg = TConfig(orient_block=3, **(KCFG_T if kernels else {}))
    et = TEngine(p, t_orients(p), model, images, cfg, device="cpu")
    assert et.n_orient_pad > et.n_orient and not et._replayed()
    st = et.initial_state()
    for b in range(et.ang_blocks.shape[0]):
        st = et._block_step(st, et.banks, et.ang_blocks[b], b * et.o_block, et.mask_blocks[b])
    got = et.run()
    for key, a, b in zip(PosteriorState._fields, got, st):
        assert a is not None and torch.equal(a, b), key


def test_hoisted_prior_equals_the_per_block_prior(rng):
    """The engine computes the CTF prior once: it equals the per-block
    ctf_prior_term of the port on the engine's banks, bit for bit, and the
    JAX package's on its banks (rtol 1e-13, test_torch_posterior's bound)."""
    from bioem_tpu.core.posterior import ctf_prior_term as j_prior
    from bioem_tpu_torch.core.posterior import ctf_prior_term

    p, model, images = _problem(rng, 2)
    ej, et = _engines(p, model, images, {}, {})
    bk = et.banks
    assert et._prior.dtype == torch.float64 and et._prior.shape == (et.n_ctf,)
    assert torch.equal(et._prior, ctf_prior_term(bk.amp, bk.pha, bk.env, p))
    want = np.asarray(j_prior(ej.banks.amp, ej.banks.pha, ej.banks.env, p))
    np.testing.assert_allclose(et._prior.numpy(), want, rtol=1e-13)
