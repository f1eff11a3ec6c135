"""Shared set-up of the benchmark's own tests (run them from the repo root:
``python -m pytest benchmark/tests``)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skipped on machines without one")


def shrink(cell, n: int = 48, n_images: int = 6, n_models: int = 3):
    """``cell`` cut to a size the CPU runs in seconds: N = ``n``, 64
    orientations, 2 CTFs, D = 5, a 40-point model; the
    widths the check depends on (the lattice, the CTF physics) kept."""
    cell = copy.deepcopy(cell)
    cfg = cell.cfg
    cfg.update(n_pixels=n, max_displace_center=4, grid_space_center=2)
    cfg["orientations"] = {"kind": "super_fibonacci", "n": 64, "count": 64}
    cfg["ctf"].update(n_defocus=2, n_bfactor=1)
    cfg["model"].update(n_points=40, radius_A=15.0 * n / 48)
    cell.mix.update(n_images=n_images, check_images=n_images,
                    n_models=min(cell.mix.get("n_models", 1), n_models))
    return cell


@pytest.fixture
def cell_of():
    """A cell of the repo's BENCHMARK.json, shrunk (:func:`shrink`)."""
    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

    def make(name, **kw):
        return shrink(harness.find_cell(bench, name), **kw)

    return make
