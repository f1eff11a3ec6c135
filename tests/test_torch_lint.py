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
  the test suite in the package.
"""

import os
import re

import pytest

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
    from bioem_tpu_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast" not in flags
