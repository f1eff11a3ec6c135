"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``bioem_tpu_torch/csrc/*.cu`` are compiled with nvcc, one process per
source, all started together, and linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds, not
minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libbioem_kernels_<hash>.so *.o

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

from ..utils.timestat import count, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LIB = None
build_info: dict = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
D = ctypes.c_double

# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints).
SIGNATURES = {
    "bioem_fourier_project": [P] * 7 + [I] * 5 + [P, P, P],
    "bioem_project_prologue": [P, I] + [P] * 5 + [I] * 4 + [F] + [I] * 2 + [P] * 4 + [P],
    "bioem_fourier_project_max_n": [],
    "bioem_raster_project": ([P, I] + [P] * 4 + [I] * 3 + [F] + [I] * 3 + [F] * 2 + [P] * 4
                             + [ctypes.c_size_t, P]),
    "bioem_raster_scratch_bytes": [I] * 4 + [F],
    "bioem_raster_max_stencil_half": [],
    "bioem_raster_project_lattice": ([P, I, P, I, I, I, P, P] + [I] * 3 + [F] + [I] * 3
                                     + [F] * 3 + [P] * 4 + [ctypes.c_size_t, P]),
    "bioem_raster_lattice_scratch_bytes": [I, I],
    "bioem_raster_lattice_max_reach": [],
    "bioem_raster_lattice_tile": [],
    "bioem_raster_lattice_margin": [],
    "bioem_bounds_census": [P, I, I, P, P, I, I, F, I, I, P, P],
    "bioem_fused_compare": [P] * 12 + [F] + [I] * 10 + [P] * 5 + [P],
    "bioem_fused_displacement_cc": [P] * 8 + [I] * 9 + [P] * 2 + [P],
    "bioem_fused_compare_batched": [P] * 12 + [F] + [I] * 9 + [P] * 4 + [P],
    "bioem_probe_compare": [I] + [P] * 12 + [F] + [I] * 10 + [P] * 5 + [P],
    "bioem_probe_compare_batched": [I] + [P] * 12 + [F] + [I] * 9 + [P] * 4 + [P],
    "bioem_probe_f32_product": [I, P, P, P, I, I, I, I, P],
    "bioem_probe_product_sum": [I, P, P, P, P, I, I, I, I, I, I, P],
    "bioem_fused_compare_smem_bytes": [I] * 6,
    "bioem_fused_compare_scratch_bytes": [I] * 8,
    "bioem_compare_batched_smem_bytes": [I, I, I],
    "bioem_block_constants": [P] * 9 + [I] * 5 + [D, D, I] + [I] * 5 + [P] * 8 + [P],
    "bioem_merge_block": [P] * 12 + [I] * 5 + [D] + [P] * 11 + [P],
    "bioem_error_string": [I],
}
RESTYPES = {
    "bioem_fused_compare_smem_bytes": ctypes.c_size_t,
    "bioem_fused_compare_scratch_bytes": ctypes.c_size_t,
    "bioem_compare_batched_smem_bytes": ctypes.c_size_t,
    "bioem_raster_scratch_bytes": ctypes.c_size_t,
    "bioem_raster_lattice_scratch_bytes": ctypes.c_size_t,
    "bioem_raster_lattice_margin": ctypes.c_float,
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
    path. One nvcc per source runs in parallel, then one links them.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel) and records the compiler output in ``build_info["log"]``.
    A failed build raises."""
    extra = ("-Xptxas", "-v") if verbose else ()
    out = library_path(extra)
    if os.path.exists(out):
        build_info.update(path=out, seconds=0.0, cached=True)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    count("bioem.library.builds")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, _obj, proc in jobs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(obj for _c, obj, _p in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    build_info.update(
        path=out, seconds=time.perf_counter() - t0, cached=False,
        log="".join(log) + proc.stdout + proc.stderr,
    )
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use (see :func:`build`). The
    first load in the process is span ``bioem.library``: the sources'
    hash, nvcc when the hash is new (counter ``bioem.library.builds``),
    dlopen and the signatures."""
    global _LIB
    if _LIB is None:
        with span("bioem.library"):
            lib = ctypes.CDLL(build(verbose=verbose))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
        _LIB = lib
    return _LIB


def check_tensors(fn: str, device, specs) -> None:
    """Raise ValueError unless each (name, tensor, dtype, shape) of
    ``specs`` lies on ``device`` with that dtype and shape, contiguous:
    what a kernel wrapper checks before it hands pointers to its kernel."""
    for name, t, dtype, shape in specs:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{fn}: {name} must be {dtype} {tuple(shape)} on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        msg = _LIB.bioem_error_string(status).decode() if _LIB is not None else ""
        raise RuntimeError(f"{what}: CUDA error {status} {msg}")
