"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``bioem_tpu_torch/csrc/*.cu`` are compiled with nvcc into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libbioem_kernels_<hash>.so csrc/*.cu

The library lands in ``bioem_tpu_torch/_build/`` keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time: importing the package needs no
nvcc and no GPU. No fast-math flag: the comparison kernel needs the
libdevice ``log1pf``/``expf`` (a_coef ≈ −N²/2 amplifies any error).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIB = None
build_info: dict = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints).
SIGNATURES = {
    "bioem_fourier_project": [P, P, P, P, P, I, I, I, I, I, P, P, P],
    "bioem_fused_compare": [P] * 12 + [F] + [I] * 8 + [P] * 4 + [P],
    "bioem_fused_displacement_cc": [P] * 8 + [I] * 7 + [P] + [P],
    "bioem_compare_smem_bytes": [I, I, I],
    "bioem_error_string": [I],
}
RESTYPES = {
    "bioem_compare_smem_bytes": ctypes.c_size_t,
    "bioem_error_string": ctypes.c_char_p,
}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path(extra_flags: tuple = ()) -> str:
    h = hashlib.sha256()
    for f in (*NVCC_FLAGS, *extra_flags):
        h.update(f.encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbioem_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the hashed library is missing; return its
    path. ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel) and records the compiler output in
    ``build_info["log"]``. A failed build raises."""
    extra = ("-Xptxas", "-v") if verbose else ()
    out = library_path(extra)
    if os.path.exists(out):
        build_info.update(path=out, seconds=0.0, cached=True)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_info.update(
        path=out, seconds=secs, cached=False, log=proc.stdout + proc.stderr
    )
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use (see :func:`build`)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build(verbose=verbose))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _LIB = lib
    return _LIB


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        msg = _LIB.bioem_error_string(status).decode() if _LIB is not None else ""
        raise RuntimeError(f"{what}: CUDA error {status} {msg}")
