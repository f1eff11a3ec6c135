"""The port's SO(3) quaternion-list tool (bioem_tpu_torch.utils.so3)
writes the same bytes as the JAX package's (bioem_tpu.utils.so3), and the
port's orientation reader reads the list back (tests/test_tools.py's
round trip)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bioem_tpu.utils import so3 as j_so3
from bioem_tpu_torch.core.orientations import build_orientations, read_orientation_file
from bioem_tpu_torch.utils import so3

from .conftest import tiny_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [576, 4608])
def test_so3_list_bytes_equal_jax_and_read_back(n, tmp_path):
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "bioem_tpu_torch.utils.so3", str(n), str(ours)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"Wrote {n} quaternions" in out.stdout
    j_so3.make_quaternion_list(str(theirs), n)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(so3.super_fibonacci(n), j_so3.super_fibonacci(n))

    p = tiny_params(use_quaternions=True, grid_points_quaternion=1)
    p.not_uniform_angles = True
    orients = read_orientation_file(p, str(ours))
    assert orients.n == n and orients.use_quaternions
    np.testing.assert_allclose(orients.angles, so3.super_fibonacci(n), atol=1e-6)
    assert build_orientations(p, str(ours)).n == n


def test_so3_rejects_empty():
    with pytest.raises(ValueError):
        so3.super_fibonacci(0)
