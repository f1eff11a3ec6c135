"""The port's DEBUG_PROB dump (``bioem_tpu_torch.debug_prob``) against the
JAX package's on the same seeded problems, against the port engine's own
posterior, through the CLI's environment hook, and its diff entry point.

Tolerances. tests/test_debug_prob.py holds the JAX package's two paths to
|Δcc| < 5e-4·max(1, max|cc|) and |Δlogpro| < 0.05 (the TPU's 3-pass bf16
body); every port-vs-JAX comparison here is held to those. The plain
branch against the JAX einsum path also meets a tighter bound the port's
true ``log1p`` allows: |Δlogpro| < 1e-5 (measured 1.8e-6 at N=16, 1.5e-6
at N=64; the JAX dump's ``accurate_log1p`` series and the einsum order
make up the rest) and |Δcc| < 1e-6·max|cc|.
"""

import os

import numpy as np
import pytest

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.debug_prob import dump_logpro as j_dump
from bioem_tpu.debug_prob import write_dump as j_write
from bioem_tpu_torch import debug_prob as D
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core.engine import BioEMEngine
from bioem_tpu_torch.core.orientations import build_orientations

from .conftest import tiny_images, tiny_model, tiny_params


def _problem(rng, n=16):
    p = tiny_params(n_pixels=n, pixel_size=96.0 / n)
    return p, tiny_model(rng), tiny_images(rng, 2, n)


def _port_engine(p, model, images, kernels=False):
    cfg = RunConfig(orient_block=2, use_kernels=kernels)
    return BioEMEngine(p, build_orientations(p), model, images, cfg, device="cpu")


def logsumexp(x):
    m = x.max()
    return m + np.log(np.exp(x - m).sum())


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("j_kernel,t_kernel", [("xla", "plain"), ("pallas", "kernel")])
def test_dump_matches_jax(rng, n, j_kernel, t_kernel):
    """JAX XLA vs the port's plain branch; JAX Pallas (interpret mode) vs
    the port's kernel branch (K3's plain version on the CPU)."""
    p, model, images = _problem(rng, n)
    ej = JEngine(p, j_orients(p), model, images, JConfig(orient_block=2, use_pallas=False))
    et = _port_engine(p, model, images, kernels=t_kernel == "kernel")
    lp_j, cc_j = j_dump(ej, 1, kernel=j_kernel)
    lp_t, cc_t = D.dump_logpro(et, 1)  # the engine's own branch
    assert lp_t.shape == lp_j.shape == (et.n_orient, et.n_ctf, len(et.disp), len(et.disp))
    assert lp_t.dtype == cc_t.dtype == np.float64 and np.isfinite(lp_t).all()
    scale = max(1.0, float(np.abs(cc_j).max()))
    dcc = float(np.abs(cc_t - cc_j).max())
    dlog = float(np.abs(lp_t - lp_j).max())
    assert dcc < 5e-4 * scale and dlog < 0.05
    if t_kernel == "plain":
        assert dcc < 1e-6 * scale and dlog < 1e-5


@pytest.mark.parametrize("kernels", [False, True])
def test_dump_matches_engine_posterior(rng, kernels):
    """The log-sum-exp over the dump's evaluations is the engine's streaming
    accumulator for that image (tests/test_debug_prob.py:39-59's rule), and
    its argmax is the engine's best tuple."""
    p, model, images = _problem(rng)
    eng = _port_engine(p, model, images, kernels)
    state = eng.run()
    for i in range(eng.n_img):
        lp, _ = D.dump_logpro(eng, i)
        want = float(np.log(state.total[i].item()) + state.const[i].item())
        assert abs(logsumexp(lp) - want) < 1e-6 * max(1.0, abs(want))
        o, c, ix, iy = np.unravel_index(np.argmax(lp), lp.shape)
        assert int(state.best_orient[i]) == o and int(state.best_conv[i]) == c
        assert int(state.best_cent_x[i]) == -int(eng.disp[ix])
        assert int(state.best_cent_y[i]) == -int(eng.disp[iy])


def test_dump_no_map_norm_matches_jax(rng):
    """DC-dominated images take the f64 u on both packages' dumps."""
    p = tiny_params(no_map_norm=True)
    model, images = tiny_model(rng), tiny_images(rng, 2, 16)
    images.maps[:] += np.float32(3.0)
    ej = JEngine(p, j_orients(p), model, images, JConfig(orient_block=2, use_pallas=False))
    et = _port_engine(p, model, images, kernels=True)
    assert not et._f32_corr_ok
    lp_j, cc_j = j_dump(ej, 0, kernel="pallas")
    lp_t, cc_t = D.dump_logpro(et, 0, kernel="pallas")  # the JAX name of the kernel branch
    assert float(np.abs(cc_t - cc_j).max()) < 5e-4 * max(1.0, float(np.abs(cc_j).max()))
    assert float(np.abs(lp_t - lp_j).max()) < 0.05


def test_dump_rejects_bad_requests(rng):
    p, model, images = _problem(rng)
    eng = _port_engine(p, model, images)
    with pytest.raises(ValueError, match="kernel="):
        D.dump_logpro(eng, 0, kernel="mosaic")
    with pytest.raises(ValueError, match="outside"):
        D.dump_logpro(eng, eng.n_img)


def test_dumps_diff_across_packages(rng, tmp_path, capsys):
    """One text format: a port dump and a JAX dump of the same image diff
    clean through both packages' diff entry points, and the port's exits
    1 when the tolerance is below the difference or the keys differ."""
    from tools.diff_prob_dump import main as j_diff_main

    p, model, images = _problem(rng)
    ej = JEngine(p, j_orients(p), model, images, JConfig(orient_block=2, use_pallas=False))
    et = _port_engine(p, model, images)
    fa, fb = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    lp_j, cc_j = j_dump(ej, 0, kernel="xla")
    j_write(fa, 0, lp_j, cc_j, np.asarray(ej.disp))
    lp_t, cc_t = D.dump_logpro(et, 0)
    D.write_dump(fb, 0, lp_t, cc_t, et.disp)
    a, b = D.read_dump(fa), D.read_dump(fb)
    assert len(a) == len(b) == lp_t.size
    dlog, _dcc, worst, n_common, only_a, only_b = D.diff_dumps(a, b)
    assert n_common == lp_t.size and not only_a and not only_b and dlog > 0
    assert D.main([fa, fb, "--atol", "1e-5"]) == 0
    assert "MATCH" in capsys.readouterr().out
    assert j_diff_main([fa, fb, "--atol", "1e-5"]) == 0
    assert D.main([fa, fb, "--atol", str(dlog / 10)]) == 1
    with open(fb) as f:
        lines = f.readlines()
    with open(fb, "w") as f:
        f.writelines(lines[1:])
    assert D.main([fa, fb, "--atol", "1.0"]) == 1
    assert "MISMATCH" in capsys.readouterr().out


def _write_cli_inputs(rng, tmp_path, n=16):
    pts = rng.uniform(-6, 6, (8, 3))
    radii = rng.uniform(1.0, 3.0, 8)
    dens = rng.uniform(40, 100, 8)
    with open(tmp_path / "model.txt", "w") as f:
        for k in range(8):
            f.write(f"{pts[k, 0]:.4f} {pts[k, 1]:.4f} {pts[k, 2]:.4f} "
                    f"{radii[k]:.4f} {dens[k]:.4f}\n")
    maps = rng.normal(0, 1, (1, n, n))
    with open(tmp_path / "particles.txt", "w") as f:
        f.write("PARTICLE 0\n")
        for i in range(n):
            for j in range(n):
                f.write(f"{i:8d}{j:8d}{maps[0, i, j]:16.8f}\n")
    with open(tmp_path / "param.txt", "w") as f:
        f.write("PIXEL_SIZE 1.5\n" f"NUMBER_PIXELS {n}\n" "GRIDPOINTS_ALPHA 2\n"
                "GRIDPOINTS_BETA 2\n" "CTF_B_ENV 2.0 100.0 2\n" "CTF_DEFOCUS 0.5 1.5 2\n"
                "CTF_AMPLITUDE 0.1 0.1 1\n" "DISPLACE_CENTER 2 1\n")


@pytest.mark.parametrize("kernel", ["", "plain", "kernel", "xla", "pallas"])
def test_env_gated_cli_dump(rng, monkeypatch, tmp_path, kernel):
    """BIOEM_TPU_DEBUG_PROB writes a parseable dump after a CLI run (on
    the CPU by BIOEM_TPU_FORCE_CPU), on either branch, and the dump's best
    evaluation is the output's Maximizing Param orientation."""
    from bioem_tpu_torch import cli
    from bioem_tpu_torch.params import read_parameters

    _write_cli_inputs(rng, tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    monkeypatch.setenv("BIOEM_TPU_DEBUG_PROB", "0")
    monkeypatch.setenv("BIOEM_TPU_DEBUG_PROB_FILE", "dump0.txt")
    monkeypatch.setenv("BIOEM_TPU_DEBUG_PROB_KERNEL", kernel)
    assert cli.main(["--Modelfile", "model.txt", "--Particlesfile", "particles.txt",
                     "--Inputfile", "param.txt", "--OutputFile", "out.txt"]) == 0
    assert os.path.exists("dump0.txt")
    d = D.read_dump("dump0.txt")
    assert len(d) > 0
    lps = {k: v[1] for k, v in d.items()}
    best = max(lps, key=lps.get)
    orients = build_orientations(read_parameters("param.txt"))
    want_ang = np.asarray(orients.angles)[best[1], :3]
    with open("out.txt") as f:
        (line,) = [x for x in f if x.startswith("RefMap: 0 Maximizing Param:")]
    tok = line.split()
    np.testing.assert_allclose([float(tok[5]), float(tok[7]), float(tok[9])], want_ang, atol=1e-4)


def test_cli_without_dump_env_writes_none(rng, monkeypatch, tmp_path):
    from bioem_tpu_torch import cli

    _write_cli_inputs(rng, tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    monkeypatch.delenv("BIOEM_TPU_DEBUG_PROB", raising=False)
    assert cli.main(["--Modelfile", "model.txt", "--Particlesfile", "particles.txt",
                     "--Inputfile", "param.txt", "--OutputFile", "out.txt"]) == 0
    assert not os.path.exists("debug_prob.txt")
