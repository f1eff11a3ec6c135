"""The port's examples (``bioem_tpu_torch.examples``) on the CPU, against the
JAX package's ``examples/``.

* Planted recovery: the port's scenario image equals the one the JAX
  example synthesises with its oracle on the same seed, and the drive
  passes (the planted orientation, CTF and displacement recovered, the
  refinement on the on-grid truth neither losing log-posterior nor
  moving off it).
* The tutorial: both MODEL_COMPARISON runs (the port's through
  ``python -m bioem_tpu_torch.cli``/``.rank``, the JAX package's through
  its own) rank the generating model first, and the port's
  ``Output_Probabilities`` lie within LOGP_ATOL (tests/test_golden.py) of
  the JAX tutorial's.

The entry points take the card unless asked for the CPU, so these set
BIOEM_TPU_FORCE_CPU=1.
"""

import os
import sys

import numpy as np
import pytest
import torch

from bioem_tpu_torch.examples import planted_recovery, tutorial

from .test_golden import LOGP_ATOL, parse_output

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")


@pytest.fixture
def one_torch_thread():
    """The refinement's small batched tensors run no faster on several
    threads, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_planted_scenario_equals_jax_example():
    """The JAX example's forward model (its oracle's projection and the
    JAX CTF bank) on the same seed gives the port's planted image."""
    from bioem_tpu.core.ctf import build_ctf_bank
    from bioem_tpu.params import make_ctf_grid
    from tests.oracle.oracle import project, rotmat_quat

    p, orients, model, images = planted_recovery.scenario()
    rng = np.random.default_rng(7)
    rng.uniform(-25, 25, (40, 3))
    radii = np.round(rng.uniform(2.0, 3.4, 40), 1).astype(np.float32)
    dens = rng.uniform(40, 110, 40).astype(np.float32)
    proj = project(p, model.points.astype(np.float64), radii, dens, model.norm_den,
                   rotmat_quat(orients.angles[planted_recovery.TRUE_ORIENT]))
    bank = build_ctf_bank(p, make_ctf_grid(p))
    n = p.n_pixels
    conv = np.fft.irfft2(np.fft.rfft2(proj) * np.conj(bank[planted_recovery.TRUE_CONV]), s=(n, n))
    img = np.roll(conv, (planted_recovery.TRUE_DX, planted_recovery.TRUE_DY), axis=(0, 1))
    img = img + rng.normal(0, 0.1 * img.std(), img.shape)
    img = (img - img.mean()) / img.std()
    np.testing.assert_array_equal(images.maps[0], img.astype(np.float32))
    np.testing.assert_array_equal(images.maps[1], rng.normal(0, 1, (n, n)).astype(np.float32))


def test_planted_recovery_passes(one_torch_thread):
    out = planted_recovery.run(device="cpu", say=lambda msg: None)
    assert out["recovered"] and out["refined"]
    res = out["results"]
    assert res.best_orient[0] == planted_recovery.TRUE_ORIENT
    assert (res.best_cent_x[0], res.best_cent_y[0]) == (planted_recovery.TRUE_DX,
                                                        planted_recovery.TRUE_DY)


def test_tutorial_matches_jax_tutorial(tmp_path, monkeypatch):
    """Both tutorials pass on the same seed; the posterior outputs of model
    1 agree within LOGP_ATOL (4-decimal prints of two f32 engines)."""
    assert tutorial.run(str(tmp_path / "port"), say=lambda msg: None)
    sys.path.insert(0, ROOT)
    from examples import tutorial as j_tutorial

    monkeypatch.setattr(sys, "argv", ["tutorial.py", str(tmp_path / "jax")])
    j_tutorial.main()  # raises unless model 1 wins
    lp, _, par = parse_output((tmp_path / "port" / "Output_m1").read_text())
    lp_j, _, par_j = parse_output((tmp_path / "jax" / "Output_m1").read_text())
    assert len(lp) == len(lp_j) == tutorial.N_IMG
    np.testing.assert_allclose(lp, lp_j, rtol=0, atol=LOGP_ATOL)
    ranking = (tmp_path / "port" / "Model_Ranking").read_text()
    assert "#1 model1.txt" in ranking
