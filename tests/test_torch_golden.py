"""The reference-binary goldens through the port's CLI
(``bioem_tpu_torch.cli.main``) on the CPU, at test_golden.py's tolerances.

Each case runs on both branches of the port's block step: the plain torch
branch (the CPU default) and the kernel branch (``use_kernels=True``; on
CPU tensors every kernel wrapper takes its plain version), so the kernel
branch's host logic — separable convolution sums, the f64 max repair, the
cc-out route for DC-dominated banks — is pinned to the reference binary
here too. The same cases run on the card through chip_smoke.py.
"""

import os
import re
import shutil

import numpy as np
import pytest

from .test_golden import CASE_ATOL, CASES, DATA, F64_CASES, LOGP_ATOL, parse_output


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


@pytest.mark.parametrize("argv,env", [
    (["--PrintBestCalMap", "best.txt", "--Modelfile", "m.txt"], {}),
    (["--Refine"], {}),
    (["--RefineCTF"], {}),
    ([], {"BIOEM_TPU_MESH_ORIENT": "2"}),
    ([], {"BIOEM_TPU_DEBUG_PROB": "0"}),
    ([], {"BIOEM_TPU_CHECKPOINT": "ckpt.npz"}),
])
def test_not_ported_features_refuse(argv, env, monkeypatch):
    """Features of the JAX CLI that the port lacks raise NotImplementedError
    before any work starts; they never run something else."""
    from bioem_tpu_torch.cli import main

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(argv)


def test_single_device_mesh_is_accepted(monkeypatch):
    """A 1×1 mesh is the single device the port runs on."""
    from bioem_tpu_torch.config import not_ported_env

    monkeypatch.setenv("BIOEM_TPU_MESH_IMAGES", "1")
    monkeypatch.setenv("BIOEM_TPU_MESH_ORIENT", "1")
    assert not_ported_env() == []
