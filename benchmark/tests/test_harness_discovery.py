"""A configuration, a traffic mix, a limit file and a metric reader dropped
into their folders are found by the names in BENCHMARK.json, with no
existing file edited; and a run refuses to hold JAX or the JAX package."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

from conftest import ROOT

NEW_METRIC = '''"""Passes per second of the window (a test's drop-in reader)."""


def read(run):
    return len(run.pass_s) / run.window_s
'''

DRIVE = """
import json, sys
from benchmark import harness
bench = harness.load_json("BENCHMARK.json")
cell = harness.find_cell(bench, "tiny48.fewimages")
out = harness.run_cell(cell, 12, 0.2, False, "cpu", 0.0)["result"]
print(json.dumps(harness.finite(out)))
"""


def _digests(folder):
    out = {}
    for base, _dirs, files in os.walk(folder):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(base, f)
                out[os.path.relpath(p, folder)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    src = os.path.join(ROOT, "benchmark")
    dst = tmp_path / "benchmark"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("tests", "_cache", "__pycache__"))
    before = _digests(dst)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = harness.load_json(os.path.join(src, "configs", "refgrid224.json"))
    cfg.update(name="tiny48", n_pixels=48, max_displace_center=4, grid_space_center=2)
    cfg["orientations"] = {"kind": "super_fibonacci", "n": 64, "count": 64}
    cfg["ctf"].update(n_defocus=2, n_bfactor=1)
    cfg["model"].update(n_points=40, radius_A=15.0)
    (dst / "configs" / "tiny48.json").write_text(json.dumps(cfg))
    mix = dict(harness.load_json(os.path.join(src, "mixes", "set64.json")), n_images=4, check_images=4)
    (dst / "mixes" / "fewimages.json").write_text(json.dumps(mix))
    (dst / "limits" / "tiny48.fewimages.json").write_text(json.dumps({"logp_gap": 1e-3, "argmax_lp_gap": 1e-3}))
    (dst / "metrics" / "passes_per_s.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny48", "source": "a test", "file": "benchmark/configs/tiny48.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny48.fewimages", "config": "tiny48", "traffic": "fewimages",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "passes_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["tiny48.fewimages"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(os.path.join(ROOT, "bioem_tpu_torch"), tmp_path / "bioem_tpu_torch")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out
    assert set(out["metrics"]) == {"comparisons_per_s", "setup_s", "passes_per_s"}
    assert out["metrics"]["passes_per_s"]["value"] > 0
    after = _digests(dst)
    assert {k: v for k, v in after.items() if k in before} == before


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["bioem_tpu_torch", "bioem_tpu_torch.core", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "bioem_tpu.core.engine", "flax", "jaxlib"]) == \
        ["bioem_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package(cell_of):
    code = ("import sys, json\nfrom benchmark import harness\nfrom conftest import shrink\n"
            "bench = harness.load_json('BENCHMARK.json')\n"
            "cell = shrink(harness.find_cell(bench, 'refgrid224.rank2x20'))\n"
            "harness.run_cell(cell, 5, 0.1, True, 'cpu', 0.0)\n"
            "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "benchmark", "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "refgrid224.set64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
