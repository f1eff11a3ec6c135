"""Test configuration: force an 8-device CPU mesh for sharding tests.

Mirrors the reference's "multi-node testing without a cluster" strategy
(mpirun on one box, /root/reference/doc/index.rst:1367-1389): we emulate an
8-chip TPU topology on host CPU via XLA's host-platform device count.
"""

import os

# Force CPU: the test suite must not depend on TPU availability, and the
# 8-device mesh emulation below only works on the host platform. NOTE: the
# env var JAX_PLATFORMS is overridden by TPU plugins in some environments;
# jax.config.update is authoritative.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from bioem_tpu.io.map_io import ImageStack  # noqa: E402
from bioem_tpu.io.model_io import Model  # noqa: E402
from bioem_tpu.params import BioEMParams  # noqa: E402


def tiny_params(**kw) -> BioEMParams:
    """A small CTF-mode configuration for oracle comparisons."""
    defaults = dict(
        pixel_size=1.5,
        n_pixels=16,
        n_amp=1,
        start_amp=0.1,
        end_amp=0.1,
        n_phase=2,
        start_defocus=0.5,
        end_defocus=1.5,
        n_env=2,
        start_bfactor=1.0,
        end_bfactor=100.0,
        max_displace_center=2,
        grid_space_center=1,
        grid_points_alpha=2,
        grid_points_beta=2,
    )
    defaults.update(kw)
    p = BioEMParams(**defaults)
    return p.finalize_ctf_mode()


def tiny_model(rng, n_points=12, spread=6.0, with_radius=True) -> Model:
    pts = rng.uniform(-spread, spread, size=(n_points, 3)).astype(np.float32)
    if with_radius:
        radii = rng.uniform(1.0, 3.2, size=n_points).astype(np.float32)
    else:
        radii = np.full(n_points, 1.0, np.float32)
    dens = rng.uniform(40.0, 100.0, size=n_points).astype(np.float32)
    return Model(pts, radii, dens, float(dens.astype(np.float64).sum()))


def tiny_images(rng, n_img, n_pixels) -> ImageStack:
    maps = rng.normal(0.0, 1.0, size=(n_img, n_pixels, n_pixels)).astype(np.float32)
    # normalise like MRC ingest so sref≈0, ssref≈N²
    flat = maps.reshape(n_img, -1).astype(np.float64)
    mean = flat.mean(axis=1)
    sig = np.sqrt((flat**2).mean(axis=1) - mean**2)
    maps = (maps / sig[:, None, None] - (mean / sig)[:, None, None]).astype(np.float32)
    return ImageStack(maps)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _isolate_autotune_cache(tmp_path, monkeypatch):
    """Keep the autotuner's persistent cache out of the repo tree."""
    monkeypatch.setenv(
        "BIOEM_TPU_AUTOTUNE_CACHE", str(tmp_path / "autotune_cache.json")
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA CUDA card (the port's hand-written kernels); "
        "skipped on machines without one",
    )
