"""Two processes on gloo reproduce the one-process mesh run bit for bit
(the port's tests/test_multihost.py).

Each of two worker processes (tests/torch_mp_worker.py, the port only)
holds two CPU slots of a global 2×2 (images × orientations) mesh; the
reference is the same mesh in one process with four slots, run by the
same worker in the same mode. Same slots, same order, same arithmetic:
every output equals the reference bit for bit, for a plain run, a
streamed run in which each process reads only the rows its slots own, a
checkpointed run and its resumption, and the CLI. (A streamed run is held
to the streamed one-process run: on the CPU the plain branch's products
see a chunk's images, not the whole set, so streamed and whole runs
differ in the last bits and are held to each other at the suite's
tolerance.) Every subprocess has a ``communicate(timeout=...)`` and the
group a 60 s collective timeout, so a hang fails the test within about
two minutes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BIOEM_TPU", "BIOEM_DEBUG"))}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update(OMP_NUM_THREADS="1", BIOEM_TPU_FORCE_CPU="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **extra)
    return env


def _wait(procs):
    logs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = pr.communicate()
            logs.append(out)
            pytest.fail("a worker hung:\n" + "\n".join(x or "" for x in logs))
        logs.append(out)
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, f"worker rc={pr.returncode}\n{log}"
    return logs


def _launch(tmp_path, mode, ckpt="", name="mp.npz"):
    out = str(tmp_path / name)
    if mode.startswith("single-"):
        procs = [subprocess.Popen([sys.executable, WORKER, out, mode, ckpt], env=_env(),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    else:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, WORKER, out, mode, ckpt],
            env=_env(BIOEM_TPU_COORDINATOR=f"127.0.0.1:{port}", BIOEM_TPU_NUM_PROCESSES="2",
                     BIOEM_TPU_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    _wait(procs)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def single_process_ref(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("single"), "single-run")


@pytest.fixture(scope="module")
def single_process_streamed(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("single"), "single-stream")


def _equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_single_process_mesh_matches_jax_single(single_process_ref):
    """The reference itself: the worker's one-process 2×2 mesh equals the
    JAX package's single engine on tests/mp_worker.py's problem."""
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.engine import BioEMEngine
    from tests.mp_worker import build_tiny_problem

    p, orients, model, images = build_tiny_problem()
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=2))
    ref = eng.results(eng.run())
    np.testing.assert_allclose(single_process_ref["log_prob"], ref.log_prob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(single_process_ref["best_orient"], ref.best_orient)
    np.testing.assert_array_equal(single_process_ref["best_conv"], ref.best_conv)


def test_two_process_run_matches_single(tmp_path, single_process_ref):
    _equal(_launch(tmp_path, "run"), single_process_ref)


def test_two_process_streamed_run(tmp_path, single_process_ref, single_process_streamed):
    """Streamed × meshed × two processes, with per-process reads (process 1
    reads at most one placeholder row of chunk 2; the worker asserts it),
    equal to the one-process streamed run, and to the whole run at the
    suite's tolerance."""
    got = _launch(tmp_path, "stream")
    _equal(got, single_process_streamed)
    np.testing.assert_allclose(got["log_prob"], single_process_ref["log_prob"],
                               rtol=1e-9, atol=1e-7)
    for k in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(got[k], single_process_ref[k], err_msg=k)


def test_two_process_checkpointed_run_and_resume(tmp_path, single_process_ref):
    """Each process checkpoints its own slots (<path>.slot<i>x<o>); a second
    launch loads the completed files and equals the reference too."""
    ckpt = str(tmp_path / "mh.npz")
    _equal(_launch(tmp_path, "run", ckpt=ckpt), single_process_ref)
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("mh.npz.slot"))
    assert files == ["mh.npz.slot0x0", "mh.npz.slot0x1", "mh.npz.slot1x0", "mh.npz.slot1x1"]
    _equal(_launch(tmp_path, "run", ckpt=ckpt, name="again.npz"), single_process_ref)


def _write_cli_inputs(d):
    """tests/test_multihost.py's CLI inputs (text model, PARTICLE file,
    keyword file)."""
    from tests.test_multihost import _write_cli_inputs as write

    write(d)


def _cli(cwd, **extra):
    env = _env(BIOEM_TPU_ORIENT_BLOCK="2", BIOEM_TPU_MESH_IMAGES="2",
               BIOEM_TPU_MESH_ORIENT="2", **extra)
    return subprocess.Popen(
        [sys.executable, "-m", "bioem_tpu_torch.cli", "--Modelfile", "model.txt",
         "--Particlesfile", "particles.txt", "--Inputfile", "param.txt"],
        cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_two_process_matches_single(tmp_path):
    """The unmodified CLI in two processes (BIOEM_TPU_COORDINATOR/
    _NUM_PROCESSES/_PROCESS_ID) writes, from process 0, the same
    Output_Probabilities and ANG_PROB bytes as one process on the same
    2×2 mesh."""
    one, two = tmp_path / "single", tmp_path / "multi"
    for d in (one, two):
        d.mkdir()
        _write_cli_inputs(d)
    _wait([_cli(one)])
    port = _free_port()
    _wait([_cli(two, BIOEM_TPU_COORDINATOR=f"127.0.0.1:{port}", BIOEM_TPU_NUM_PROCESSES="2",
                BIOEM_TPU_PROCESS_ID=str(pid)) for pid in range(2)])
    ref = (one / "Output_Probabilities").read_text()
    assert "RefMap: 0 LogProb:" in ref
    assert (two / "Output_Probabilities").read_text() == ref
    assert (two / "ANG_PROB").read_text() == (one / "ANG_PROB").read_text()
