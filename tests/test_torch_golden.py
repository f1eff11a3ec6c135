"""The reference-binary goldens through the port's CLI
(``bioem_tpu_torch.cli.main``) on the CPU, at test_golden.py's tolerances.

Each case runs on both branches of the port's block step: the plain torch
branch (the CPU default) and the kernel branch (``use_kernels=True``; on
CPU tensors every kernel wrapper takes its plain version), so the kernel
branch's host logic — separable convolution sums, the f64 max repair, the
cc-out route for DC-dominated banks — is pinned to the reference binary
here too. The same cases run on the card through chip_smoke.py. The CLI
runs on the card unless asked for the CPU, so these set
BIOEM_TPU_FORCE_CPU=1. --PrintBestCalMap (golden case M) is host NumPy
and is held to the reference binary's BESTMAP and to the JAX simulator.
"""

import os
import re
import shutil

import numpy as np
import pytest

from .test_golden import CASE_ATOL, CASES, DATA, F64_CASES, LOGP_ATOL, parse_output


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")


@pytest.fixture(params=["plain", "kernel"])
def branch(request, monkeypatch):
    if request.param == "kernel":
        from bioem_tpu_torch.config import RunConfig

        original = RunConfig.from_env

        def from_env():
            cfg = original()
            cfg.use_kernels = True
            return cfg

        monkeypatch.setattr(RunConfig, "from_env", staticmethod(from_env))
    return request.param


def run_port_cli(case, tmp_path, golden_name="Output_Probabilities.golden"):
    from bioem_tpu_torch.cli import main

    model_file, maps_file, extra, *_ = CASES[case]
    work = tmp_path / case
    shutil.copytree(os.path.join(DATA, case), work)
    old = os.getcwd()
    os.chdir(work)
    try:
        assert main(["--Modelfile", model_file, "--Particlesfile", maps_file,
                     "--Inputfile", "param.txt", "--OutputFile", "Output_Probabilities.port",
                     *extra]) == 0
    finally:
        os.chdir(old)
    return ((work / "Output_Probabilities.port").read_text(),
            (work / golden_name).read_text(), work)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_golden_case(case, tmp_path, branch):
    _, _, _, has_ang, a, centers_exact = CASES[case]
    atol = CASE_ATOL.get(case, LOGP_ATOL)
    ours, golden, work = run_port_cli(case, tmp_path)
    lp_t, _, par_t = parse_output(ours)
    lp_g, _, par_g = parse_output(golden)
    assert len(lp_t) == len(lp_g) > 0
    np.testing.assert_allclose(lp_t, lp_g, atol=atol)
    for pt, pg in zip(par_t, par_g):
        assert len(pt) == len(pg)
        np.testing.assert_allclose(pt[0], pg[0], atol=atol)
        np.testing.assert_allclose(pt[1: a + 4], pg[1: a + 4], atol=1e-3)
        if centers_exact:
            np.testing.assert_array_equal(pt[a + 4: a + 6], pg[a + 4: a + 6])
        np.testing.assert_allclose(pt[a + 6:], pg[a + 6:], atol=2e-3)
    if not has_ang:
        return

    def ang_values(text):
        vals = {}
        for line in text.splitlines():
            m = re.match(r"\s*(\d+)\s+((?:-?\d+\.\d+\s+){4})(-?\d+\.\d+) Separated:", line)
            if m:
                vals.setdefault(int(m.group(1)), []).append(float(m.group(3)))
        return vals

    ours_ang = ang_values((work / "ANG_PROB").read_text())
    gold_ang = ang_values((work / "ANG_PROB.golden").read_text())
    assert set(ours_ang) == set(gold_ang)
    for img in gold_ang:
        np.testing.assert_allclose(sorted(ours_ang[img]), sorted(gold_ang[img]), atol=atol)


@pytest.mark.parametrize("case", F64_CASES)
def test_port_golden_f64_external_truth(case, tmp_path, branch):
    _, _, _, _, n_ang, _ = CASES[case]
    ours, golden, _ = run_port_cli(case, tmp_path, "Output_Probabilities.f64.golden")
    lp_t, _, par_t = parse_output(ours)
    lp_g, _, par_g = parse_output(golden)
    assert len(lp_t) == len(lp_g) > 0
    np.testing.assert_allclose(lp_t, lp_g, rtol=0, atol=2e-3)
    for pt, pg in zip(par_t, par_g):
        np.testing.assert_allclose(pt[1: n_ang + 4], pg[1: n_ang + 4], atol=1e-4)
        np.testing.assert_array_equal(pt[n_ang + 4: n_ang + 6], pg[n_ang + 4: n_ang + 6])


@pytest.mark.parametrize("env", [
    {"BIOEM_TPU_MESH_IMAGES": "2"}, {"BIOEM_TPU_MESH_ORIENT": "2"},
    {"BIOEM_TPU_MESH_IMAGES": "2", "BIOEM_TPU_MESH_ORIENT": "2"},
    {"BIOEM_TPU_NATIVE_IO": "1"},
], ids=["mesh2x1", "mesh1x2", "mesh2x2", "native_io"])
def test_mesh_and_native_cli_match_single(env, tmp_path, monkeypatch):
    """The JAX CLI's features the port refused until this slice (the device
    mesh, the native ingest) run through the port's CLI on golden case A:
    a 2×1, 1×2 and 2×2 mesh of CPU slots, and the C++ reader, each
    matching the single-device run on the NumPy readers (logP rtol 1e-9,
    the parameter columns equal) and the reference binary's golden."""
    from bioem_tpu_torch.runtime import native

    case = "case_a_euler_ctf"
    monkeypatch.setenv("BIOEM_TPU_NATIVE_IO", "0")
    single, golden, _ = run_port_cli(case, tmp_path / "single")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = native.calls["text_maps"]
    ours, _, _ = run_port_cli(case, tmp_path / "env")
    assert (native.calls["text_maps"] > before) == (env.get("BIOEM_TPU_NATIVE_IO") == "1")
    lp, _, par = parse_output(ours)
    lp_1, _, par_1 = parse_output(single)
    lp_g, _, _ = parse_output(golden)
    assert len(lp) == len(lp_1) == len(lp_g) > 0
    np.testing.assert_allclose(lp, lp_1, rtol=1e-9, atol=0)
    np.testing.assert_allclose(lp, lp_g, atol=CASE_ATOL.get(case, LOGP_ATOL))
    for a, b in zip(par, par_1):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [["--Refine"], ["--Refine", "--RefineCTF"],
                                   ["--Refine", "--RefineCTF", "--RefineCTFAmp"]])
def test_refine_flags_are_ported(flags, monkeypatch):
    """--Refine and its CTF variants no longer refuse: without the
    mandatory files the CLI reports them, as for any run."""
    from bioem_tpu_torch.cli import main

    for name in ("BIOEM_TPU_MESH_IMAGES", "BIOEM_TPU_NATIVE_IO"):
        monkeypatch.delenv(name, raising=False)
    assert main(flags) == 1


def test_single_device_mesh_is_accepted(tmp_path, monkeypatch):
    """A 1×1 mesh is the single device: the CLI's engine is a BioEMEngine."""
    from bioem_tpu_torch import run as trun
    from bioem_tpu_torch.core.engine import BioEMEngine

    monkeypatch.setenv("BIOEM_TPU_MESH_IMAGES", "1")
    monkeypatch.setenv("BIOEM_TPU_MESH_ORIENT", "1")
    made = []
    original = trun.make_engine

    def make_engine(*a, **kw):
        made.append(original(*a, **kw))
        return made[-1]

    monkeypatch.setattr(trun, "make_engine", make_engine)
    run_port_cli("case_a_euler_ctf", tmp_path)
    assert len(made) == 1 and type(made[0]) is BioEMEngine


BESTMAP_TOL = 2.5e-3


def bestmap_error(ours: str, golden: str) -> tuple:
    """tests/test_golden.py:206-240's BESTMAP comparison, shared with
    chip_smoke.py: the line and token structure must be identical and the
    labels exact (else ValueError). Returns (max |Δ|/(1+|golden|) over the
    float tokens, their count); the rule's 2.5e-3 abs + 2.5e-3 rel is that
    maximum ≤ BESTMAP_TOL."""
    if len(ours.splitlines()) != len(golden.splitlines()):
        raise ValueError("BESTMAP: line structure differs")
    ot, gt = ours.split(), golden.split()
    if not len(ot) == len(gt) > 0:
        raise ValueError("BESTMAP: token count differs")
    worst, n_float = 0.0, 0
    for a, b in zip(ot, gt):
        if ("." in b) or ("e" in b and b not in ("MAP", "MAPddx")):
            worst = max(worst, abs(float(a) - float(b)) / (1 + abs(float(b))))
            n_float += 1
        elif a != b:
            raise ValueError(f"BESTMAP: token {a!r} where the golden has {b!r}")
    return worst, n_float


def test_port_golden_bestmap_values(tmp_path):
    """--PrintBestCalMap through the port's CLI against the reference
    binary's BESTMAP, at tests/test_golden.py:206-240's rule: token
    structure identical, floats within 2.5e-3 abs + 2.5e-3 rel."""
    from bioem_tpu_torch.cli import main

    work = tmp_path / "case_m_bestmap"
    shutil.copytree(os.path.join(DATA, "case_m_bestmap"), work)
    old = os.getcwd()
    os.chdir(work)
    try:
        assert main(["--Modelfile", "model.txt", "--PrintBestCalMap", "best.txt"]) == 0
    finally:
        os.chdir(old)
    worst, n_float = bestmap_error((work / "BESTMAP").read_text(),
                                   (work / "BESTMAP.golden").read_text())
    assert worst <= BESTMAP_TOL and n_float >= 2 * 16 * 16


BEST_FILES = {
    # tests/test_cli.py:120-134's case: Euler angles, CTF, a displacement
    "euler_ctf": ("PIXEL_SIZE 1.5\nNUMBER_PIXELS 16\n"
                  "BEST_ALPHA 0.1\nBEST_BETA 0.2\nBEST_GAMMA 0.3\n"
                  "BEST_CTF_B_ENV 10.0\nBEST_CTF_DEFOCUS 1.0\nBEST_CTF_AMP 0.1\n"
                  "BEST_DX 1\nBEST_DY -1\nBEST_NORM 2.0\nBEST_OFFSET 0.5\n"),
    "quat_psf": ("PIXEL_SIZE 1.5\nNUMBER_PIXELS 16\nUSE_QUATERNIONS\n"
                 "BEST_Q1 0.1\nBEST_Q2 -0.3\nBEST_Q3 0.5\nBEST_Q4 0.8\nUSE_PSF\n"
                 "BEST_PSF_ENVELOPE 20.0\nBEST_PSF_PHASE 2.0\nBEST_PSF_AMP 0.3\n"
                 "BEST_DX -2\nBEST_DY 0\nBEST_NORM 1.2\nBEST_OFFSET -0.1\n"),
    "shift": ("PIXEL_SIZE 1.5\nNUMBER_PIXELS 16\nBEST_ALPHA 0.7\nBEST_BETA 1.1\n"
              "BEST_GAMMA -0.4\nBEST_CTF_B_ENV 80.0\nBEST_CTF_DEFOCUS 2.0\n"
              "BEST_CTF_AMP 0.2\nSHIFT_X 1\nSHIFT_Y -1\nBEST_DX 3\nBEST_DY 2\n"),
}


@pytest.mark.parametrize("name", sorted(BEST_FILES))
def test_port_print_best_map_matches_jax(name, tmp_path, rng):
    """The port's --PrintBestCalMap writes the JAX CLI's BESTMAP byte for
    byte (both are host NumPy on the same copied code)."""
    from bioem_tpu.cli import main as j_main
    from bioem_tpu_torch.cli import main as t_main

    pts = rng.uniform(-6, 6, (10, 3))
    radii = rng.uniform(1.0, 3.0, 10)
    dens = rng.uniform(40, 100, 10)
    with open(tmp_path / "model.txt", "w") as f:
        for k in range(10):
            f.write(f"{pts[k, 0]:.4f} {pts[k, 1]:.4f} {pts[k, 2]:.4f} "
                    f"{radii[k]:.4f} {dens[k]:.4f}\n")
    (tmp_path / "best.txt").write_text(BEST_FILES[name])
    out = {}
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for tag, main in (("jax", j_main), ("port", t_main)):
            assert main(["--Modelfile", "model.txt", "--PrintBestCalMap", "best.txt"]) == 0
            out[tag] = (tmp_path / "BESTMAP").read_text()
    finally:
        os.chdir(old)
    assert "\nMAP " in out["port"] and "MAPddx" in out["port"]
    assert out["port"] == out["jax"]
