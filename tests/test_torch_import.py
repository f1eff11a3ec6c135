"""The PyTorch port never imports JAX (nor the JAX package, bench.py or the
test suite), and chip_smoke.py refuses to run without a CUDA card.

Both checks run in a subprocess: conftest.py has already imported JAX into
the test process, so ``sys.modules`` there says nothing about the port.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

IMPORT_ALL = """
import importlib, pkgutil, sys
import bioem_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "bioem_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m in ("jax", "bioem_tpu", "bench", "tests")
             or m.startswith(("jax.", "bioem_tpu.", "tests.")))
assert not bad, bad
print(" ".join(names))
"""

# the accuracy, scale and profiling entry points, the benchmark harness and
# the examples
TOOLS = ("oracle", "golden_error_budget", "accuracy_probe", "problem", "profile_block",
         "trace_step", "pipeline_lab", "scale_bench", "stream_50k", "rank_bench",
         "mesh_scale_bench", "noise_recovery_table", "bench")
EXAMPLES = ("planted_recovery", "tutorial")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the package was imported (package layout sanity),
    # the tools and examples among them; none pulled in JAX, the JAX
    # package, bench.py or the test suite
    names = set(out.stdout.split())
    assert len(names) >= 20
    assert {f"bioem_tpu_torch.tools.{t}" for t in TOOLS} <= names
    assert {f"bioem_tpu_torch.examples.{e}" for e in EXAMPLES} <= names


def _no_cuda() -> bool:
    import torch

    return not torch.cuda.is_available()


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    """No CUDA device → nonzero exit and no result line. Alone in a
    directory (no package beside it) it fails as well; where a card is
    present only that second case is checked."""
    runs = [[sys.executable, os.path.join(ROOT, "chip_smoke.py")]] if _no_cuda() else []
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    runs.append([sys.executable, str(lone)])
    for cmd in runs:
        out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
