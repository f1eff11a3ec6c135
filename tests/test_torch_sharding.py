"""The port's (images × orientations) mesh (parallel/mesh.py) against the
JAX package's ShardedBioEMEngine and single engine on the same seed-made
tiny problem, at tests/test_sharding.py's tolerances (logP atol 1e-5,
argmax tuples equal), with every slot on the CPU (``devices=['cpu']*8``).

Also: the port's kernel branches (K1, K4, the hybrid; their plain versions
on the CPU) on a 2×2 mesh against the port's single engine on the same
branch; too few devices; a checkpointed run resumed from one slot's saved
file; streaming, ranking, the DEBUG_PROB dump and refinement through a
mesh (tests/test_stream_rank.py's sharded cases); the merge's tie rule;
and the multi-process bootstrap's resolution order.
"""

import os

import numpy as np
import pytest
import torch

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.parallel.mesh import ShardedBioEMEngine as JSharded
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core.engine import BioEMEngine
from bioem_tpu_torch.core.orientations import build_orientations
from bioem_tpu_torch.core.posterior import init_state
from bioem_tpu_torch.parallel import distributed
from bioem_tpu_torch.parallel.mesh import (ShardedBioEMEngine, make_bioem_mesh,
                                           merge_across_orient)

from .conftest import tiny_images, tiny_model, tiny_params

ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")
CPU8 = ["cpu"] * 8


@pytest.fixture
def problem(rng):
    p = tiny_params(write_angles=3)
    return p, tiny_model(rng), tiny_images(rng, 5, p.n_pixels)


def _mesh_engine(p, model, images, mi, mo, **kw):
    cfg = RunConfig(orient_block=2, mesh_images=mi, mesh_orient=mo, **kw)
    return ShardedBioEMEngine(p, build_orientations(p), model, images, cfg,
                              mesh=make_bioem_mesh(mi, mo, devices=CPU8))


def _single(p, model, images, **kw):
    eng = BioEMEngine(p, build_orientations(p), model, images,
                      RunConfig(orient_block=2, **kw), device="cpu")
    return eng.results(eng.run())


def _held(res, ref, atol=1e-5, exact=False):
    if exact:
        np.testing.assert_array_equal(res.log_prob, ref.log_prob)
        np.testing.assert_array_equal(res.angle_log, ref.angle_log)
        np.testing.assert_array_equal(res.best_norm, ref.best_norm)
    else:
        np.testing.assert_allclose(res.log_prob, ref.log_prob, rtol=0, atol=atol)
        np.testing.assert_allclose(res.angle_log, ref.angle_log, rtol=0, atol=atol)
        np.testing.assert_allclose(res.best_norm, ref.best_norm, rtol=1e-5)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_mesh_matches_jax_sharded_and_single(problem, mesh_shape):
    """tests/test_sharding.py:33's shapes: the port's mesh equals the JAX
    package's mesh and its single engine, and the port's single engine
    bit for bit (the plain branch computes each image and orientation
    block alone)."""
    p, model, images = problem
    mi, mo = mesh_shape
    eng = _mesh_engine(p, model, images, mi, mo)
    assert len(eng.slots) == mi * mo and eng.n_devices == 1
    res = eng.results(eng.run())
    jm = JSharded(p, j_orients(p), model, images,
                  JConfig(orient_block=2, mesh_images=mi, mesh_orient=mo))
    _held(res, jm.results(jm.run()))
    je = JEngine(p, j_orients(p), model, images, JConfig(orient_block=2))
    _held(res, je.results(je.run()))
    _held(res, _single(p, model, images), exact=True)


@pytest.mark.parametrize("branch", [
    dict(fused_lse=True), dict(fused_lse=True, fused_batched=True), dict(fused_lse=False)],
    ids=["K1", "K4", "hybrid"])
def test_mesh_kernel_branches(problem, branch):
    """The kernel branch on a 2×2 mesh (the wrappers' plain versions on the
    CPU) equals the port's single engine on the same branch at the suite's
    logP tolerance (rtol 1e-9, atol 1e-7) with the argmax tuples exact,
    and the JAX single engine at 1e-4 (test_sharding.py:159's)."""
    p, model, images = problem
    kw = dict(use_kernels=True, kernel_img_tile=2, **branch)
    eng = _mesh_engine(p, model, images, 2, 2, **kw)
    assert eng.fused_batched == branch.get("fused_batched", False)
    assert all(e._f32_corr_ok for e in eng.slots.values())
    res = eng.results(eng.run())
    # the plain versions batch the slot's images in one product, so the
    # CPU's product blocking differs from the single engine's
    single = _single(p, model, images, **kw)
    np.testing.assert_allclose(res.log_prob, single.log_prob, rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(res.angle_log, single.angle_log, rtol=1e-9, atol=1e-7)
    _held(res, single)
    je = JEngine(p, j_orients(p), model, images, JConfig(orient_block=2))
    _held(res, je.results(je.run()), atol=1e-4)


def test_one_branch_for_every_slot(rng):
    """The comparison gate is the whole stack's: a DC-dominated image in one
    image shard puts every slot on the hybrid, as the single engine."""
    p = tiny_params(write_angles=3)
    images = tiny_images(rng, 4, p.n_pixels)
    images.maps[3] += 5.0  # DC-dominated: only image shard 1 holds it
    eng = _mesh_engine(p, tiny_model(rng), images, 2, 2, use_kernels=True,
                       kernel_img_tile=2)
    assert not any(e._f32_corr_ok for e in eng.slots.values())


def test_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="needs 256 devices, have 8"):
        make_bioem_mesh(16, 16, devices=CPU8)
    with pytest.raises(ValueError):
        make_bioem_mesh(0, 2, devices=CPU8)


def test_mesh_slots_and_padding(problem):
    """Images pad to a multiple of i_block × n_img_shards and orientations to
    o_block × n_orient_shards, so the slots are equal; slot (i, o) holds
    image rows [i·R, (i+1)·R) and orientations from o·O_local."""
    p, model, images = problem
    eng = _mesh_engine(p, model, images, 2, 4)
    rows = eng.n_img_pad // 2
    assert eng.n_img_pad % (eng.i_block * 2) == 0 and eng.n_orient_pad % (eng.o_block * 4) == 0
    for (i, o), e in eng.slots.items():
        assert e.img_rows == (i * rows, (i + 1) * rows)
        assert e.orient_base == o * (eng.n_orient_pad // 4)
        assert e.ang_blocks.shape[0] * e.o_block == e.n_orient_local
    assert eng.owned_image_rows() == [(0, eng.n_img_pad)]


def test_mesh_checkpoint_resumed_from_one_slot(rng, tmp_path):
    """Each slot checkpoints its pre-merge state to <path>.slot<i>x<o>; a run
    whose slot (1, 1) stopped after one block resumes that slot from its
    file and equals the straight run."""
    p = tiny_params(write_angles=2)
    model = tiny_model(rng)
    images = tiny_images(rng, 4, p.n_pixels)
    ref_eng = _mesh_engine(p, model, images, 2, 2)
    ref = ref_eng.results(ref_eng.run())
    ckpt = str(tmp_path / "mesh.npz")
    kw = dict(checkpoint_path=ckpt, checkpoint_every=1)
    eng = _mesh_engine(p, model, images, 2, 2, **kw)
    _held(eng.results(eng.run()), ref, exact=True)
    for i in range(2):
        for o in range(2):
            assert os.path.exists(f"{ckpt}.slot{i}x{o}")
    # slot (1, 1) saved after its first block only
    from bioem_tpu_torch.runtime.checkpoint import save_checkpoint

    e11 = eng.slots[(1, 1)]
    off, ang_off = e11._offsets(0)
    st = e11._block_step(e11.initial_state(), e11.banks, e11.ang_blocks[0], off,
                         e11.mask_blocks[0], ang_offset=ang_off)
    save_checkpoint(f"{ckpt}.slot1x1", st, 1, e11._fingerprint)
    resumed = _mesh_engine(p, model, images, 2, 2, **kw, debug_output=1)
    _held(resumed.results(resumed.run()), ref, exact=True)
    # another slot's file does not fit slot (1, 1) (its fingerprint names
    # the slot): a copy of slot (0, 0)'s completed file is ignored
    os.replace(f"{ckpt}.slot0x0", f"{ckpt}.slot1x1")
    fresh = _mesh_engine(p, model, images, 2, 2, **kw)
    _held(fresh.results(fresh.run()), ref, exact=True)


def test_streamed_mesh_matches_mesh_and_jax(rng):
    """tests/test_stream_rank.py:110: 4 chunks of 2 images streamed through
    a 2×4 mesh equal the non-streamed mesh run, and the JAX package's
    streamed sharded run."""
    from bioem_tpu.stream import ArraySource as JArraySource
    from bioem_tpu.stream import run_streaming as j_run_streaming
    from bioem_tpu_torch.stream import ArraySource, run_streaming

    p = tiny_params(write_angles=2)
    model = tiny_model(rng)
    images = tiny_images(rng, 8, p.n_pixels)
    eng = _mesh_engine(p, model, images, 2, 4)
    ref = eng.results(eng.run())
    cfg = RunConfig(orient_block=2, mesh_images=2, mesh_orient=4)
    res, perf = run_streaming(p, build_orientations(p), model, ArraySource(images.maps), cfg,
                              chunk_images=2, device="cpu")
    assert perf["chunks"] == 4
    _held(res, ref, exact=True)
    jres, _ = j_run_streaming(p, j_orients(p), model, JArraySource(images.maps),
                              JConfig(orient_block=2, mesh_images=2, mesh_orient=4),
                              chunk_images=2)
    _held(res, jres)


def test_rank_on_mesh_matches_single_and_jax(rng):
    """tests/test_stream_rank.py:154: ranking through the mesh's swap_model
    (each slot copies the model and its counts) equals the single engine's
    ranking and the JAX package's mesh ranking."""
    from bioem_tpu.rank import rank_models as j_rank_models
    from bioem_tpu_torch.rank import rank_models

    p = tiny_params()
    models = [tiny_model(rng, n_points=12), tiny_model(rng, n_points=9)]
    images = tiny_images(rng, 4, p.n_pixels)
    orients = build_orientations(p)
    _t1, per_1, _ = rank_models(p, orients, models, images, RunConfig(orient_block=2),
                                device="cpu")
    _tm, per_m, perf = rank_models(
        p, orients, models, images,
        RunConfig(orient_block=2, mesh_images=2, mesh_orient=2), device="cpu")
    np.testing.assert_array_equal(per_m, per_1)
    assert len(perf["results"]) == 2
    _tj, per_j, _ = j_rank_models(p, j_orients(p), models, images,
                                  JConfig(orient_block=2, mesh_images=2, mesh_orient=2))
    np.testing.assert_allclose(per_m, per_j, rtol=0, atol=1e-5)


def test_debug_prob_dump_on_mesh(problem):
    """The DEBUG_PROB dump of an image through the mesh's slots equals the
    single engine's dump."""
    from bioem_tpu_torch.debug_prob import dump_logpro

    p, model, images = problem
    eng = _mesh_engine(p, model, images, 2, 4)
    single = BioEMEngine(p, build_orientations(p), model, images, RunConfig(orient_block=2),
                         device="cpu")
    for image in (0, 4):
        lp, cc = dump_logpro(eng, image)
        lp1, cc1 = dump_logpro(single, image)
        np.testing.assert_array_equal(lp, lp1)
        np.testing.assert_array_equal(cc, cc1)


def test_refine_on_mesh_matches_single(problem):
    """refine_results on a mesh engine in one process gathers the image
    shards' rows to the first slot's device and equals the single engine's
    refinement."""
    from bioem_tpu_torch.refine import refine_results

    p, model, images = problem
    eng = _mesh_engine(p, model, images, 2, 2)
    res = eng.results(eng.run())
    single = BioEMEngine(p, build_orientations(p), model, images, RunConfig(orient_block=2),
                         device="cpu")
    kw = dict(iters=3, n_starts=2)
    a = refine_results(eng, res, **kw)
    b = refine_results(single, single.results(single.run()), **kw)
    np.testing.assert_array_equal(a.logpro_refined, b.logpro_refined)
    np.testing.assert_array_equal(a.rotmat, b.rotmat)


def test_merge_across_orient_rule():
    """const = the max, total rescaled and summed in f64, the argmax tuple
    from the lowest shard holding the max (ties go to earlier
    orientations), slabs concatenated."""
    a = init_state(3, 2, True)
    b = init_state(3, 2, True)
    a.const.copy_(torch.tensor([1.0, 5.0, 2.0], dtype=torch.float64))
    b.const.copy_(torch.tensor([3.0, 5.0, 1.0], dtype=torch.float64))
    a.total.fill_(2.0)
    b.total.fill_(4.0)
    a.best_orient.copy_(torch.tensor([0, 1, 2], dtype=torch.int32))
    b.best_orient.copy_(torch.tensor([10, 11, 12], dtype=torch.int32))
    b.ang_total.fill_(7.0)
    m = merge_across_orient([a, b])
    np.testing.assert_array_equal(m.const.numpy(), [3.0, 5.0, 2.0])
    np.testing.assert_array_equal(m.best_orient.numpy(), [10, 1, 2])  # tie → shard 0
    np.testing.assert_allclose(m.total.numpy(),
                               [2 * np.exp(-2.0) + 4, 6.0, 2 + 4 * np.exp(-1.0)], rtol=1e-15)
    assert m.ang_total.shape == (3, 4) and float(m.ang_total[0, 2]) == 7.0


def test_initialize_resolution(monkeypatch):
    """No configuration: a no-op single process; a partial one raises; a
    launcher advertising several processes without a rendezvous raises."""
    for k in ("BIOEM_TPU_COORDINATOR", "BIOEM_TPU_NUM_PROCESSES", "BIOEM_TPU_PROCESS_ID",
              "WORLD_SIZE", "RANK", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not distributed.is_initialized() and distributed.process_count() == 1
    monkeypatch.setenv("BIOEM_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="partial"):
        distributed.initialize()
    monkeypatch.delenv("BIOEM_TPU_NUM_PROCESSES")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize()
    assert not distributed.is_initialized()
