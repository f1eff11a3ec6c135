"""Static precision and hygiene lint over the PyTorch port.

The port's accuracy contract (ROADMAP.md precision rules) cannot be seen
by a CPU test run: TF32 and fast-math intrinsics only exist on the card.
So, in the manner of test_precision_lint.py, these rules are enforced on
the source text of ``bioem_tpu_torch/`` and ``chip_smoke.py``:

* nothing turns TF32 on (``allow_tf32 = True``) or lowers
  ``set_float32_matmul_precision`` below ``"highest"``;
* no fast-math build flag and no approximate log/exp intrinsics in the
  CUDA sources (a_coef ≈ −N²/2 amplifies any log1p error);
* no import of JAX anywhere in the port, and no import of bench.py or
  the test suite in the package;
* the ``extern "C"`` entry points of ``bioem_tpu_torch/csrc/*.cu`` and
  ``ops/_build.SIGNATURES`` agree (each entry defined once, its
  parameters and return type as ctypes declares them, no entry point
  undeclared): a mismatch would otherwise show only on the card.
"""

import ctypes
import glob
import os
import re

import pytest

from bioem_tpu_torch.ops import _build

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "bioem_tpu_torch")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        if "_build" in dirpath or "__pycache__" in dirpath:
            continue
        out += [os.path.join(dirpath, n) for n in names
                if n.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


FILES = _files()
IDS = [os.path.relpath(f, ROOT) for f in FILES]

RULES = [
    (re.compile(r"allow_tf32\s*=\s*True"), "TF32 switched on"),
    (re.compile(r"set_float32_matmul_precision\(\s*['\"](high|medium)['\"]"),
     "f32 matmul precision lowered below 'highest'"),
    (re.compile(r"use_fast_math"), "fast-math build flag"),
    (re.compile(r"__logf|__expf|__log1pf|__powf"), "approximate intrinsic"),
    (re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+bioem_tpu\b|from\s+bioem_tpu[\s.])",
                re.M), "JAX (or the JAX package) imported"),
]


def test_lint_sees_the_port():
    names = {os.path.basename(f) for f in FILES}
    assert {"compare_fused.cu", "compare_batched.cu", "compare_lse.cuh", "project.cu", "probe.cu",
            "wgmma.cuh", "posterior_glue.cu", "project_glue.cu", "project_raster.cu",
            "project_snap.cuh", "engine.py", "compare_cuda.py", "project_cuda.py",
            "probe_cuda.py", "posterior_cuda.py", "debug_prob.py", "simulator.py",
            "kernel_probe.py", "chip_smoke.py"} <= names
    rel = set(IDS)
    tools = ("oracle", "golden_error_budget", "accuracy_probe", "problem", "profile_block",
             "trace_step", "pipeline_lab", "scale_bench", "stream_50k", "rank_bench",
             "mesh_scale_bench", "noise_recovery_table", "bench")
    assert {f"bioem_tpu_torch/tools/{t}.py" for t in tools} <= rel
    assert {"bioem_tpu_torch/examples/planted_recovery.py",
            "bioem_tpu_torch/examples/tutorial.py"} <= rel


# The package keeps its own copy of what it needs: no import of the JAX
# package's benchmark script or of the test suite (chip_smoke.py, a script
# beside the tests, may read the goldens' tolerances from them).
OUTSIDE = re.compile(r"^\s*(import\s+(bench|tests)\b|from\s+(bench|tests)[\s.])", re.M)
PKG_FILES = [f for f in FILES if f.endswith(".py") and os.path.basename(f) != "chip_smoke.py"]


@pytest.mark.parametrize("path", PKG_FILES, ids=[os.path.relpath(f, ROOT) for f in PKG_FILES])
def test_package_imports_no_bench_or_tests(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    bad = [src[:m.start()].count(chr(10)) + 1 for m in OUTSIDE.finditer(src)]
    assert not bad, f"{os.path.relpath(path, ROOT)}: bench or tests imported at lines {bad}"


@pytest.mark.parametrize("path", FILES, ids=IDS)
def test_port_precision_and_hygiene(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    bad = [f"{what} at line {src[:m.start()].count(chr(10)) + 1}"
           for rx, what in RULES for m in rx.finditer(src)]
    assert not bad, f"{os.path.relpath(path, ROOT)}: {bad}"


def test_engine_turns_tf32_off():
    """The engine must pin both TF32 switches off on CUDA (a float32
    convolution through cuDNN defaults to TF32)."""
    with open(os.path.join(PKG, "core", "engine.py")) as f:
        src = f.read()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in src
    assert "torch.backends.cudnn.allow_tf32 = False" in src


def test_build_flags_are_exact():
    """nvcc builds for sm_90a without fast math."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast" not in flags


# The C types of the entry points' parameters and results, as ctypes passes
# them (every pointer, the stream included, as c_void_p).
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double,
           "size_t": ctypes.c_size_t}


def _ctype(decl: str):
    """The ctypes type of a C type ``decl`` (a pointer: c_void_p; const char*:
    c_char_p); None where the lint knows no such type."""
    decl = " ".join(decl.replace("const", " ").split())
    if decl.replace(" ", "") == "char*":
        return ctypes.c_char_p
    return ctypes.c_void_p if "*" in decl else C_TYPES.get(decl)


def _entry_points() -> dict:
    """{name: [(source, return type, [parameter types])]} of every function
    defined at the top level of an ``extern "C" { ... }`` block of
    ``csrc/*.cu`` (comments and preprocessor lines stripped, function
    bodies skipped)."""
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(PKG, "csrc", "*.cu"))):
        with open(path, encoding="utf-8") as f:
            src = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
        src = re.sub(r"^[ \t]*#(?:[^\n]*\\\n)*[^\n]*", "", src, flags=re.M)
        starts = [m.end() for m in re.finditer(r'extern\s+"C"\s*\{', src)]
        assert len(starts) == src.count('extern "C"'), f"{path}: an extern \"C\" outside a block"
        for at in starts:
            depth, top = 0, []
            for ch in src[at:]:
                if ch == "}" and depth == 0:
                    break
                if depth == 0:
                    top.append(ch)
                depth += (ch == "{") - (ch == "}")
            for m in re.finditer(r"([A-Za-z_][\w\s*]*?)\s*\b(\w+)\s*\(([^()]*)\)\s*\{",
                                 "".join(top)):
                params = [p.strip() for p in m.group(3).split(",")]
                types = [_ctype(re.sub(r"\w+$", "", p)) for p in params if p not in ("", "void")]
                out.setdefault(m.group(2), []).append(
                    (os.path.basename(path), _ctype(m.group(1)), types))
    return out


ENTRY_POINTS = _entry_points()


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_its_definition(name):
    """A declared entry point is defined in exactly one source, with the
    parameters ``SIGNATURES`` gives (their number and their ctypes types)
    and the return type ``RESTYPES`` gives (c_int by default)."""
    defs = ENTRY_POINTS.get(name, [])
    assert len(defs) == 1, f"{name} defined in {[d[0] for d in defs] or 'no source'}"
    src, restype, params = defs[0]
    argtypes = _build.SIGNATURES[name]
    assert len(params) == len(argtypes), (
        f"{name} ({src}): {len(params)} parameters, SIGNATURES gives {len(argtypes)}")
    assert params == argtypes, f"{name} ({src}): parameters {params}, SIGNATURES {argtypes}"
    assert restype == _build.RESTYPES.get(name, ctypes.c_int), f"{name} ({src}): returns {restype}"


def test_every_entry_point_is_declared():
    """Every ``extern "C"`` function of the sources is in ``SIGNATURES``
    (``load()`` sets the types of those alone)."""
    assert ENTRY_POINTS, "no extern \"C\" entry point found under csrc/"
    undeclared = sorted(set(ENTRY_POINTS) - set(_build.SIGNATURES))
    assert not undeclared, f"entry points missing from SIGNATURES: {undeclared}"
