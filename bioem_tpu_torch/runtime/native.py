"""ctypes bindings for the C++ ingest runtime (src/bioem_io.cpp).

PyTorch port's counterpart of ``bioem_tpu.runtime.native``, with its own
copy of the source. The library is compiled with g++ at first use into
``bioem_tpu_torch/_build/libbioem_io_<hash>.so``, where the hash covers the
source, the compiler and the flags (not file times: a ``git archive``
checkout resets them). No ``-march=native``, so a cached library runs on
any x86-64 host that shares the build directory. Concurrent first builds
(pytest workers, the processes of a mesh run) take a file lock and
compile into a temporary name that ``os.replace`` moves into place.

Every entry point returns None when the library is unavailable, and the
readers in ``bioem_tpu_torch.io`` then parse with NumPy, as the JAX
package's do. ``BIOEM_TPU_NATIVE_IO=0`` selects the NumPy readers. A
failed build warns once with the compiler's stderr rather than fall back
silently. ``calls`` counts the native reads that ran, per entry point.

The C++ tier mirrors the reference's native readers (map.cpp, model.cpp,
include/mrc.h): multi-threaded parse of production-scale particle stacks,
the one host-side path where Python throughput matters.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from collections import Counter

import numpy as np

_ERR_LEN = 512
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "runtime", "src", "bioem_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None
_lib_failed = False
calls: Counter = Counter()


def native_io_enabled() -> bool:
    return os.environ.get("BIOEM_TPU_NATIVE_IO", "1") != "0"


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> str:
    """The cached library's path for this source, compiler and flags."""
    h = hashlib.sha256()
    for part in (_cxx(), *FLAGS):
        h.update(part.encode() + b"\0")
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbioem_io_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _file_lock(path: str):
    import fcntl

    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build() -> str:
    """Compile the library if its hashed file is missing; return its path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _file_lock(os.path.join(BUILD_DIR, "libbioem_io.lock")):
        if os.path.exists(out):  # another process built it meanwhile
            return out
        fd, tmp = tempfile.mkstemp(prefix=".libbioem_io_", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_cxx(), *FLAGS, "-o", tmp, SRC]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def get_lib():
    """The native library (built on first use), or None: disabled by
    ``BIOEM_TPU_NATIVE_IO=0`` (checked per call), or its build or load
    failed (warned once, then None for the rest of the process)."""
    global _lib, _lib_failed
    if not native_io_enabled():
        return None
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except (RuntimeError, OSError) as e:
            _lib_failed = True
            warnings.warn(
                f"native ingest unavailable, reading with NumPy instead: {e}",
                RuntimeWarning, stacklevel=3,
            )
            return None
        c_char_p = ctypes.c_char_p
        c_int = ctypes.c_int
        c_long = ctypes.c_long
        f32_p = ctypes.POINTER(ctypes.c_float)
        f64_p = ctypes.POINTER(ctypes.c_double)
        int_p = ctypes.POINTER(c_int)
        long_p = ctypes.POINTER(c_long)
        lib.bio_mrc_stack_info.argtypes = [c_char_p, c_int, int_p, c_char_p]
        lib.bio_read_mrc_stack.argtypes = [c_char_p, c_int, c_int, f32_p, c_int, c_char_p]
        lib.bio_text_maps_info.argtypes = [c_char_p, int_p, c_char_p]
        lib.bio_read_text_maps.argtypes = [c_char_p, c_int, f32_p, c_int, c_char_p]
        lib.bio_text_model_info.argtypes = [c_char_p, long_p, c_char_p]
        lib.bio_read_text_model.argtypes = [c_char_p, f64_p, c_long, c_char_p]
        _lib = lib
        return _lib


class NativeIOError(IOError):
    pass


def _err_buf():
    return ctypes.create_string_buffer(_ERR_LEN)


def _raise(err):
    raise NativeIOError(err.value.decode("utf-8", "replace"))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_mrc_stack(path: str, n_pixels: int, normalize: bool):
    """(n_img, N, N) float32 stack, or None if native IO is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    err = _err_buf()
    n_img = ctypes.c_int()
    if lib.bio_mrc_stack_info(path.encode(), n_pixels, ctypes.byref(n_img), err):
        _raise(err)
    out = np.empty((n_img.value, n_pixels, n_pixels), np.float32)
    if lib.bio_read_mrc_stack(path.encode(), n_pixels, int(normalize),
                              _ptr(out, ctypes.c_float), n_img.value, err):
        _raise(err)
    calls["mrc_stack"] += 1
    return out


def read_text_maps(path: str, n_pixels: int):
    """(n_img, N, N) float32 PARTICLE text maps, or None."""
    lib = get_lib()
    if lib is None:
        return None
    err = _err_buf()
    n_img = ctypes.c_int()
    if lib.bio_text_maps_info(path.encode(), ctypes.byref(n_img), err):
        _raise(err)
    out = np.empty((n_img.value, n_pixels, n_pixels), np.float32)
    if lib.bio_read_text_maps(path.encode(), n_pixels, _ptr(out, ctypes.c_float),
                              n_img.value, err):
        _raise(err)
    calls["text_maps"] += 1
    return out


def read_text_model(path: str):
    """(n_points, 5) float64 rows (x y z radius density), or None."""
    lib = get_lib()
    if lib is None:
        return None
    err = _err_buf()
    n_pts = ctypes.c_long()
    if lib.bio_text_model_info(path.encode(), ctypes.byref(n_pts), err):
        _raise(err)
    out = np.empty((n_pts.value, 5), np.float64)
    if lib.bio_read_text_model(path.encode(), _ptr(out, ctypes.c_double), n_pts.value, err):
        _raise(err)
    calls["text_model"] += 1
    return out
