"""The port's native C++ ingest (bioem_tpu_torch/runtime/native.py and its
own src/bioem_io.cpp) against the port's NumPy readers and the JAX
package's NumPy readers, bit for bit, on MRC stacks (both ``normalize``
values, both byte orders), PARTICLE text maps and text models.

The JAX side runs with its native reader off (``BIOEM_TPU_NATIVE_IO=0``
and its ``get_lib`` patched to None): these tests never call
``bioem_tpu.runtime.native``, whose build writes into the JAX package.
The port's library is built at first use into ``bioem_tpu_torch/_build``
(a g++ is on every machine that runs these tests).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import bioem_tpu.io.map_io as j_map_io
import bioem_tpu.io.model_io as j_model_io
import bioem_tpu.runtime.native as j_native
from bioem_tpu_torch.io import map_io, model_io
from bioem_tpu_torch.io.mrc import write_mrc
from bioem_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's readers on their NumPy path."""
    monkeypatch.setattr(j_native, "get_lib", lambda: None)


def _numpy_port(monkeypatch):
    monkeypatch.setenv("BIOEM_TPU_NATIVE_IO", "0")


def _read_both(monkeypatch, read, key):
    """(native result, port NumPy result); the native reader must run."""
    monkeypatch.delenv("BIOEM_TPU_NATIVE_IO", raising=False)
    before = native.calls[key]
    fast = read()
    assert native.calls[key] == before + 1, "the native reader did not run"
    _numpy_port(monkeypatch)
    slow = read()
    assert native.calls[key] == before + 1
    monkeypatch.delenv("BIOEM_TPU_NATIVE_IO")
    return fast, slow


def _write_text_maps(path, stack):
    with open(path, "w") as f:
        for b, m in enumerate(stack):
            f.write(f"PARTICLE  {b}\n")
            n = m.shape[0]
            for i in range(n):
                for j in range(n):
                    f.write(f"{i:8d}{j:8d}{m[i, j]:16.8f}\n")


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("byte_order", ["<", ">"])
def test_mrc_native_matches_numpy(rng, tmp_path, monkeypatch, jax_numpy, normalize, byte_order):
    stack = (rng.normal(0.3, 2.0, (6, 24, 24))).astype(np.float32)
    path = str(tmp_path / "stack.mrc")
    write_mrc(path, stack)
    if byte_order == ">":  # the whole file byte-swapped: the header vote flips
        with open(path, "rb") as f:
            raw = f.read()
        hdr = np.frombuffer(raw[:1024], dtype="<u4").byteswap()
        data = np.frombuffer(raw[1024:], dtype="<f4").byteswap()
        with open(path, "wb") as f:
            f.write(hdr.tobytes() + data.tobytes())
    fast, slow = _read_both(monkeypatch, lambda: map_io.read_mrc_maps(path, 24, normalize).maps,
                            "mrc_stack")
    assert fast.dtype == np.float32 and fast.shape == (6, 24, 24)
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, j_map_io.read_mrc_maps(path, 24, normalize).maps)


def test_text_maps_native_matches_numpy(rng, tmp_path, monkeypatch, jax_numpy):
    stack = rng.normal(0, 3, (3, 10, 10)).astype(np.float32)
    path = str(tmp_path / "parts.txt")
    _write_text_maps(path, stack)
    fast, slow = _read_both(monkeypatch, lambda: map_io.read_text_maps(path, 10).maps,
                            "text_maps")
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, j_map_io.read_text_maps(path, 10).maps)
    np.testing.assert_allclose(fast, stack, atol=5e-8)


@pytest.mark.parametrize("normalize", [True, False])
def test_read_ref_maps_native(rng, tmp_path, monkeypatch, jax_numpy, normalize):
    """The CLI's reader (read_ref_maps) on an MRC stack, native and NumPy,
    against the JAX package's."""
    stack = rng.normal(-1.0, 0.5, (4, 16, 16)).astype(np.float32)
    path = str(tmp_path / "s.mrc")
    write_mrc(path, stack)
    kw = dict(read_mrc=True, normalize=normalize)
    fast, slow = _read_both(
        monkeypatch, lambda: map_io.read_ref_maps(path, 16, **kw).maps, "mrc_stack")
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, j_map_io.read_ref_maps(path, 16, **kw).maps)


def test_text_model_native_matches_numpy(rng, tmp_path, monkeypatch, jax_numpy):
    pts = rng.uniform(-40, 40, (57, 3))
    radii = rng.uniform(1, 4, 57)
    dens = rng.uniform(10, 100, 57)
    path = str(tmp_path / "model.txt")
    with open(path, "w") as f:
        f.write("# x y z radius density\n")
        for k in range(57):
            f.write(f"{pts[k, 0]:.6f} {pts[k, 1]:.6f}\t{pts[k, 2]:.6f}  {radii[k]:.5f} "
                    f"{dens[k]:.4f}\n")
            if k == 20:
                f.write("\n")
    fast, slow = _read_both(monkeypatch, lambda: model_io.read_text_model(path), "text_model")
    ref = j_model_io.read_text_model(path)
    for a, b, c in ((fast.points, slow.points, ref.points), (fast.radii, slow.radii, ref.radii),
                    (fast.densities, slow.densities, ref.densities)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert fast.norm_den == slow.norm_den == ref.norm_den and fast.n_points == 57


def test_library_key_is_content_not_mtime(tmp_path, monkeypatch):
    """The cache key hashes the source, compiler and flags: a new mtime keeps
    the library, another flag set or source names another."""
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "bioem_tpu_torch", "_build")
    os.utime(native.SRC)
    assert native.library_path() == path
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-g",))
    assert native.library_path() != path
    assert "-march=native" not in native.FLAGS


BUILD = """
import sys
import bioem_tpu_torch.runtime.native as n
n.BUILD_DIR = sys.argv[1]
print(n.build())
"""


def test_concurrent_first_build(tmp_path):
    """Two processes building at once into an empty directory both load one
    library; no temporary file is left behind."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [pr.communicate(timeout=300) for pr in procs]
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    built = sorted(f for f in os.listdir(tmp_path) if f.endswith(".so"))
    assert built == [os.path.basename(outs[0][0].strip())]
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".libbioem_io_")]


def test_failed_build_warns_once_and_falls_back(rng, tmp_path, monkeypatch):
    """A compiler that fails: one RuntimeWarning carrying its stderr, then
    the NumPy readers, with nothing built."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal error: no compiler here' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    stack = rng.normal(0, 1, (2, 8, 8)).astype(np.float32)
    path = str(tmp_path / "s.mrc")
    write_mrc(path, stack)
    with pytest.warns(RuntimeWarning, match="no compiler here"):
        first = map_io.read_mrc_maps(path, 8).maps
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        second = map_io.read_mrc_maps(path, 8).maps
    np.testing.assert_array_equal(first, second)
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
