"""The port's checkpoint/resume, autotuner, TimeStat, time_blocks and
environment settings, against bioem_tpu's where a counterpart exists
(tests/test_runtime.py, less the mesh and TPU health-gate tests, which
have none in the port)."""

import json
import os
import re

import numpy as np
import pytest

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.runtime.checkpoint import problem_fingerprint as j_fingerprint
from bioem_tpu.runtime.checkpoint import save_checkpoint as j_save
from bioem_tpu_torch import config as tconfig
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core.engine import BioEMEngine
from bioem_tpu_torch.core.orientations import build_orientations
from bioem_tpu_torch.runtime.autotune import _cache_key, autotune_config, default_candidates
from bioem_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    problem_fingerprint,
    save_checkpoint,
)
from bioem_tpu_torch.utils.timestat import RECORDER, TimeStat, profile_trace

from .conftest import tiny_images, tiny_model, tiny_params

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _problem(rng, n_img=4, **pkw):
    p = tiny_params(**pkw)
    return p, tiny_model(rng), tiny_images(rng, n_img, p.n_pixels), build_orientations(p)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_checkpoint_resume_matches_straight_run(rng, tmp_path):
    p, model, images, orients = _problem(rng)
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=1), device="cpu")
    ref = eng.results(eng.run())

    ckpt = str(tmp_path / "state.npz")
    cfg_ck = RunConfig(orient_block=1, checkpoint_path=ckpt, checkpoint_every=2)
    eng1 = BioEMEngine(p, orients, model, images, cfg_ck, device="cpu")
    # Simulate a crash: run only the first 3 blocks by hand, checkpointing.
    state = eng1.initial_state()
    for b in range(3):
        state = eng1._block_step(state, eng1.banks, eng1.ang_blocks[b], b, eng1.mask_blocks[b])
    save_checkpoint(ckpt, state, 3, eng1._fingerprint)

    # A fresh engine resumes from block 3 and must match the straight run.
    eng2 = BioEMEngine(p, orients, model, images, cfg_ck, device="cpu")
    res = eng2.results(eng2.run())
    np.testing.assert_allclose(res.log_prob, ref.log_prob, rtol=1e-12)
    np.testing.assert_array_equal(res.best_orient, ref.best_orient)
    # run() saved at the end: the file now says every block is done
    _st, nxt = load_checkpoint(ckpt, eng2._fingerprint)
    assert nxt == eng2.ang_blocks.shape[0]


def test_checkpoint_fingerprint_mismatch_ignored(rng, tmp_path):
    p, model, images, orients = _problem(rng, n_img=2)
    cfg = RunConfig(orient_block=1, checkpoint_path=str(tmp_path / "s.npz"))
    eng = BioEMEngine(p, orients, model, images, cfg, device="cpu")
    save_checkpoint(cfg.checkpoint_path, eng.initial_state(), 2, "not-the-right-fingerprint")
    assert load_checkpoint(cfg.checkpoint_path, eng._fingerprint) is None
    # run() must ignore the stale checkpoint and still produce finite output
    res = eng.results(eng.run())
    assert np.isfinite(res.log_prob).all()


def test_checkpoint_of_another_image_padding_ignored(rng, tmp_path, capsys):
    """The fingerprint leaves out the image padding, which follows the
    kernel and its tile. A checkpoint saved by K1 at tile 32 (40 images pad
    to 64) is ignored by K4 at tile 16 (pad 48, the tile the card clamps
    the default 32 to), as a stale fingerprint is, and the run equals the
    straight one."""
    p, model, images, orients = _problem(rng, n_img=40)
    ckpt = str(tmp_path / "state.npz")
    k1 = RunConfig(orient_block=1, use_kernels=True, kernel_img_tile=32, checkpoint_path=ckpt)
    e1 = BioEMEngine(p, orients, model, images, k1, device="cpu")
    state = e1.initial_state()
    for b in range(2):
        state = e1._block_step(state, e1.banks, e1.ang_blocks[b], b, e1.mask_blocks[b])
    save_checkpoint(ckpt, state, 2, e1._fingerprint)

    k4 = dict(orient_block=1, use_kernels=True, fused_batched=True, kernel_img_tile=16)
    e4 = BioEMEngine(p, orients, model, images,
                     RunConfig(**k4, checkpoint_path=ckpt, debug_output=1), device="cpu")
    assert (e1.n_img_pad, e4.n_img_pad) == (64, 48) and e4._fingerprint == e1._fingerprint
    assert load_checkpoint(ckpt, e4._fingerprint) is not None
    res = e4.results(e4.run())
    assert "Resuming" not in capsys.readouterr().out
    ref = BioEMEngine(p, orients, model, images, RunConfig(**k4), device="cpu")
    ref = ref.results(ref.run())
    np.testing.assert_allclose(res.log_prob, ref.log_prob, rtol=1e-12)
    np.testing.assert_array_equal(res.best_orient, ref.best_orient)


@pytest.mark.parametrize("pkw,cfg", [
    ({}, dict(orient_block=2)),
    (dict(write_angles=3, max_displace_center=4, grid_space_center=2), dict(orient_block=3)),
    ({}, dict(orient_block=1, debug_break=3, debug_nmaps=2)),
])
def test_problem_fingerprint_matches_jax(rng, pkw, cfg):
    """Both packages hash the same tuple and arrays: one string."""
    p, model, images, orients = _problem(rng, **pkw)
    got = problem_fingerprint(p, orients, model, images, RunConfig(**cfg))
    want = j_fingerprint(p, j_orients(p), model, images, JConfig(**cfg))
    assert got == want
    eng = BioEMEngine(p, orients, model, images, RunConfig(**cfg), device="cpu")
    assert eng._fingerprint == want


def test_jax_checkpoint_resumes_in_the_port(rng, tmp_path):
    """A checkpoint the JAX engine wrote after block 3 resumes in the port
    (same npz layout, same fingerprint), within the tolerance
    test_torch_engine.py holds the two engines to."""
    p, model, images, orients = _problem(rng)
    ej = JEngine(p, j_orients(p), model, images, JConfig(orient_block=1))
    ref = ej.results(ej.run())
    state = ej.initial_state()
    for b in range(3):
        state = ej._step(state, ej.banks, ej.ang_blocks[b], ej.offsets[b], ej.mask_blocks[b])
    ckpt = str(tmp_path / "jax_state.npz")
    from bioem_tpu.core.posterior import PosteriorState

    j_save(ckpt, PosteriorState(*(np.asarray(v) if v is not None else None for v in state)),
           3, ej._fingerprint)
    et = BioEMEngine(p, orients, model, images,
                     RunConfig(orient_block=1, checkpoint_path=ckpt), device="cpu")
    assert et.n_img_pad == ej.n_img_pad and et._fingerprint == ej._fingerprint
    loaded = load_checkpoint(ckpt, et._fingerprint)
    assert loaded is not None and loaded[1] == 3
    res = et.results(et.run())
    np.testing.assert_allclose(res.log_prob, ref.log_prob, rtol=1e-9, atol=1e-7)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f), err_msg=f)


def test_run_prints_phase_table(rng, tmp_path, capsys):
    """A pass records its checkpoints as spans of the process's recorder,
    whose table the CLI prints once at the end of its run
    (tests/test_torch_trace.py); a pass prints no table of its own."""
    p, model, images, orients = _problem(rng, n_img=2)
    cfg = RunConfig(orient_block=2, debug_output=1,
                    checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=1)
    eng = BioEMEngine(p, orients, model, images, cfg, device="cpu")
    saved = RECORDER.count("bioem.checkpoint")
    eng.run()
    out = capsys.readouterr().out
    nblk = eng.ang_blocks.shape[0]
    assert RECORDER.count("bioem.checkpoint") - saved == nblk
    assert RECORDER.records("bioem.checkpoint")[-1].parent == "bioem.pass"
    assert re.search(r"bioem\.checkpoint\s+total .* self .*\(n=\d+\)", RECORDER.summary())
    assert "Time statistics" not in out
    eng.run()  # resumes the finished checkpoint: nothing left to do
    assert f"Resuming from checkpoint at block {nblk}/{nblk}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

def test_autotune_returns_runnable_config(rng):
    p, model, images, orients = _problem(rng)
    cfg = RunConfig(orient_block=1, autotune=True)
    cands = [RunConfig(orient_block=1), RunConfig(orient_block=2)]
    best = autotune_config(p, orients, model, images, cfg, candidates=cands, blocks=1,
                           repeats=1, device="cpu")
    assert best in cands
    eng = BioEMEngine(p, orients, model, images, best, device="cpu")
    assert np.isfinite(eng.results(eng.run()).log_prob).all()


def test_maybe_autotune_threshold(rng, monkeypatch):
    """cfg.autotune=None resolves by problem size (the reference autotunes
    every GPU run, autotuner.cpp:16-50); debug caps shrink the problem."""
    from bioem_tpu_torch import run as run_mod

    p, model, images, orients = _problem(rng)
    calls = []
    monkeypatch.setattr("bioem_tpu_torch.runtime.autotune.autotune_config",
                        lambda *a, **k: calls.append(1) or a[4])
    run_mod.maybe_autotune(p, orients, model, images, RunConfig())
    assert not calls  # tiny problem: auto stays off
    run_mod.maybe_autotune(p, orients, model, images, RunConfig(autotune=True))
    assert len(calls) == 1  # forced on: runs regardless of size
    n_cmp = orients.n * p.n_ctf * 4
    monkeypatch.setattr(run_mod, "AUTOTUNE_MIN_COMPARISONS", n_cmp)
    run_mod.maybe_autotune(p, orients, model, images, RunConfig())
    assert len(calls) == 2  # threshold crossed: auto turns on
    run_mod.maybe_autotune(p, orients, model, images, RunConfig(debug_nmaps=2))
    assert len(calls) == 2  # the capped problem is below it
    run_mod.maybe_autotune(p, orients, model, images, RunConfig(autotune=False))
    assert len(calls) == 2  # forced off beats the threshold


def test_autotune_cache_roundtrip(rng, tmp_path, monkeypatch):
    """A second autotune of the same shape reuses the recorded winner
    without timing any candidate."""
    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    p, model, images, orients = _problem(rng)
    cands = [RunConfig(orient_block=1), RunConfig(orient_block=2)]
    best = autotune_config(p, orients, model, images, RunConfig(), candidates=cands,
                           blocks=1, repeats=1, device="cpu")
    again = autotune_config(p, orients, model, images, RunConfig(orient_block=7),
                            candidates=[], blocks=1, repeats=1, device="cpu")
    assert again.orient_block == best.orient_block
    assert again.kernel_img_tile == best.kernel_img_tile
    # Different shape: cache miss → falls back to the (empty) candidates.
    images2 = tiny_images(rng, 8, p.n_pixels)
    miss = autotune_config(p, orients, model, images2, RunConfig(orient_block=7),
                           candidates=[], blocks=1, repeats=1, device="cpu")
    assert miss.orient_block == 7


def test_autotune_cache_never_overrides_forced_knobs(rng, tmp_path, monkeypatch):
    """A cached winner never re-enables a knob the user pinned: forced
    fields are left out of the cached replace and folded into the key."""
    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    p, model, images, orients = _problem(rng)
    autotune_config(p, orients, model, images, RunConfig(),
                    candidates=[RunConfig(orient_block=2)], blocks=1, repeats=1, device="cpu")
    forced_cfg = RunConfig(orient_block=4, forced=frozenset({"orient_block"}))
    assert _cache_key(p, orients.n, 4, forced_cfg, "cpu") != _cache_key(p, orients.n, 4, RunConfig(), "cpu")
    out = autotune_config(p, orients, model, images, forced_cfg,
                          candidates=[], blocks=1, repeats=1, device="cpu")
    assert out.orient_block == 4
    # even handed the free entry's fields, a forced knob keeps its value
    key = _cache_key(p, orients.n, 4, forced_cfg, "cpu")
    data = json.loads((tmp_path / "tune.json").read_text())
    data[key] = {"orient_block": 2, "use_kernels": True}
    (tmp_path / "tune.json").write_text(json.dumps(data))
    out = autotune_config(p, orients, model, images, forced_cfg,
                          candidates=[], blocks=1, repeats=1, device="cpu")
    assert out.orient_block == 4 and out.use_kernels is True


def test_autotune_corrupt_cache_does_not_crash(rng, tmp_path, monkeypatch):
    """An unparseable cache file neither crashes the load nor the store."""
    cache = tmp_path / "tune.json"
    cache.write_text("{ not json")
    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(cache))
    p, model, images, orients = _problem(rng)
    best = autotune_config(p, orients, model, images, RunConfig(),
                           candidates=[RunConfig(orient_block=2)], blocks=1, repeats=1,
                           device="cpu")
    assert best.orient_block == 2
    data = json.loads(cache.read_text())
    assert any(v.get("orient_block") == 2 for v in data.values())


def test_autotune_no_store_without_timed_candidate(rng, tmp_path, monkeypatch):
    """An empty (or all-refused) sweep never stores the untuned fallback."""
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(cache))
    p, model, images, orients = _problem(rng)
    out = autotune_config(p, orients, model, images, RunConfig(orient_block=3),
                          candidates=[], blocks=1, repeats=1, device="cpu")
    assert out.orient_block == 3
    # the engine refuses the Fourier projection for a model of 40 radii
    refused = RunConfig(projection="fourier")
    model40 = tiny_model(rng, n_points=40)
    out = autotune_config(p, orients, model40, images, RunConfig(orient_block=3),
                          candidates=[refused], blocks=1, repeats=1, device="cpu")
    assert out.orient_block == 3
    assert not cache.exists()


def test_autotune_stores_every_timed_winner_under_torch_keys(rng, tmp_path, monkeypatch):
    """No health gate in the port: a timed winner is stored, under a
    ``torch|`` key only its own package reads; a JAX entry for the same
    shape is never read."""
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(cache))
    p, model, images, orients = _problem(rng)
    from bioem_tpu.runtime.autotune import _cache_key as j_key

    cache.write_text(json.dumps({j_key(p, orients.n, 4, JConfig()): {"orient_block": 5}}))
    autotune_config(p, orients, model, images, RunConfig(),
                    candidates=[RunConfig(orient_block=2)], blocks=1, repeats=1, device="cpu")
    data = json.loads(cache.read_text())
    key = _cache_key(p, orients.n, 4, RunConfig(), "cpu")
    assert key.startswith("torch|cpu|") and data[key]["orient_block"] == 2
    assert sorted(data[key]) == sorted(("orient_block", "image_block", "use_kernels",
                                        "kernel_img_tile", "fused_lse", "fused_batched"))
    assert len(data) == 2  # the JAX entry stays, untouched


def test_autotune_debug_caps_shape_key(rng, tmp_path, monkeypatch):
    """BIOEM_DEBUG_NMAPS-capped runs tune and key at the capped shape."""
    p, model, images, orients = _problem(rng, n_img=8)
    full = _cache_key(p, orients.n, 8, RunConfig(), "cpu")
    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    autotune_config(p, orients, model, images, RunConfig(debug_nmaps=2),
                    candidates=[RunConfig(debug_nmaps=2, orient_block=2)], blocks=1,
                    repeats=1, device="cpu")
    data = json.loads((tmp_path / "t.json").read_text())
    assert full not in data
    assert any("|I2|" in k for k in data)


def test_default_candidates_cross_on_the_kernel_branch(monkeypatch):
    """The CUDA cross: orient_block ∈ {cfg, 16} × {hybrid, K1, K4}, all at
    cfg.kernel_img_tile (K4's work does not depend on its tile). K4 is a
    candidate only where the kernel library has an instance for the
    lattice and its shared memory fits (asked once per call, at D, M =
    N/n_fold, F); here a stand-in has instances up to D = 32 (the
    library's rule). On the CPU K4 runs its plain version: always a
    candidate, the library never asked."""
    from bioem_tpu_torch.ops import compare_cuda

    asked = []

    def smem(d, m, f):
        asked.append((d, m, f))
        return 1000 * (d <= 32)

    monkeypatch.setattr(compare_cuda, "batched_smem_bytes", smem)
    p = tiny_params(n_pixels=224, max_displace_center=20, grid_space_center=2)  # D=21
    cfg = RunConfig(orient_block=8, use_kernels=True)
    cands = default_candidates(cfg, p=p, device="cuda")
    combos = [(c.orient_block, c.fused_lse, c.fused_batched, c.kernel_img_tile) for c in cands]
    assert combos == [(o, lse, fb, 32) for o in (8, 16)
                      for lse, fb in ((False, False), (True, False), (True, True))]
    assert all(c.use_kernels and c.autotune is False for c in cands)
    assert asked == [(21, 112, 113)]
    p61 = tiny_params(n_pixels=224, max_displace_center=60, grid_space_center=2)  # D=61
    assert not any(c.fused_batched for c in default_candidates(cfg, p=p61, device="cuda"))
    assert asked[-1] == (61, 112, 113)
    n_asked = len(asked)
    assert sum(c.fused_batched for c in default_candidates(cfg, p=p61, device="cpu")) == 2
    assert len(asked) == n_asked
    # forced knobs keep their value, the tile included
    forced = RunConfig(orient_block=8, use_kernels=True, fused_lse=True, kernel_img_tile=4,
                       forced=frozenset({"orient_block", "fused_lse", "kernel_img_tile"}))
    assert {(c.orient_block, c.fused_lse, c.kernel_img_tile)
            for c in default_candidates(forced, p=p, device="cuda")} == {(8, True, 4)}


def test_autotune_span_is_fixed_in_comparisons(rng, tmp_path, monkeypatch):
    """Each candidate is timed over SPAN_COMPARISONS comparisons' worth of
    orientations (at least one, at most the problem's), whatever the image
    count."""
    from bioem_tpu_torch.runtime import autotune

    p, model, images, orients = _problem(rng)
    spans = []
    monkeypatch.setattr(BioEMEngine, "time_blocks",
                        lambda self, target, repeats=2: spans.append(target) or 1.0)
    per_orient = p.n_ctf * 4
    for k, (span, want) in enumerate(((3 * per_orient + 1, 3), (1, 1), (10**9, orients.n))):
        monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(tmp_path / f"t{k}.json"))
        monkeypatch.setattr(autotune, "SPAN_COMPARISONS", span)
        spans.clear()
        autotune_config(p, orients, model, images, RunConfig(),
                        candidates=[RunConfig(orient_block=1), RunConfig(orient_block=2)],
                        device="cpu")
        assert spans == [want, want]


def test_default_candidates_plain_branch():
    p = tiny_params()
    cands = default_candidates(RunConfig(), p=p, device="cpu")
    assert [(c.orient_block, c.use_kernels) for c in cands] == [(4, False), (8, False), (16, False)]


# ---------------------------------------------------------------------------
# timing and the phase table
# ---------------------------------------------------------------------------

def test_time_blocks_is_finite_and_positive(rng):
    p, model, images, orients = _problem(rng)
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=2), device="cpu")
    t = eng.time_blocks(4, repeats=1)
    assert np.isfinite(t) and t > 0


def test_timestat_summary():
    ts = TimeStat()
    with ts.time("BLOCK"):
        pass
    ts.add("BLOCK", 0.5)
    s = ts.summary()
    assert "BLOCK" in s and "mean" in s and "n=2" in s


def test_profile_trace_writes_chrome_trace(tmp_path):
    import torch

    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace.endswith(".json") and json.loads((tmp_path / "prof" / trace).read_text())
    with profile_trace(""):
        pass  # empty = no-op


# ---------------------------------------------------------------------------
# environment settings
# ---------------------------------------------------------------------------

def _jax_env_names():
    """(quoted names, every BIOEM_* match) in bioem_tpu/'s sources."""
    quoted, every = set(), set()
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "bioem_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    src = fh.read()
                quoted |= set(re.findall(r"[\"'](BIOEM_[A-Z0-9_]+)[\"']", src))
                every |= set(re.findall(r"BIOEM_[A-Z0-9_]+", src))
    return quoted, every


def test_every_jax_env_name_is_honoured_refused_or_tpu_only():
    """Every name the JAX package reads (a string literal) is in exactly one
    of the port's two sets, honoured or TPU-only: nothing is refused any
    more (the mesh, multi-process runs and the native ingest are ported).
    The other matches are prose: the prefixes BIOEM_DEBUG_* and
    BIOEM_TPU_*, and the reference binary's own BIOEM_PROB_DOUBLE and
    BIOEM_PROJ_CONV_AT_ONCE, which no code reads."""
    names, every = _jax_env_names()
    assert every - names == {"BIOEM_DEBUG_", "BIOEM_TPU_", "BIOEM_PROB_DOUBLE",
                             "BIOEM_PROJ_CONV_AT_ONCE"}
    assert len(names) >= 30
    assert not hasattr(tconfig, "NOT_PORTED_ENV")
    sets = (tconfig.HONOURED_ENV, set(tconfig.TPU_ONLY_ENV))
    for name in sorted(names):
        assert sum(name in s for s in sets) == 1, name
    assert set().union(*sets) == names  # no stale entry either


def test_env_settings_parse(monkeypatch):
    env = {
        "BIOEM_TPU_ORIENT_BLOCK": "16", "BIOEM_TPU_PALLAS_IMG_TILE": "8",
        "BIOEM_TPU_PALLAS": "1", "BIOEM_TPU_PROJ_PALLAS": "0",
        "BIOEM_TPU_FUSED_BATCHED": "1", "BIOEM_TPU_FUSED_LSE": "1",
        "BIOEM_TPU_AUTOTUNE": "0", "BIOEM_TPU_CHECKPOINT": "c.npz",
        "BIOEM_TPU_CHECKPOINT_EVERY": "4", "BIOEM_TPU_PROFILE_DIR": "prof",
        "BIOEM_TPU_MESH_IMAGES": "2", "BIOEM_TPU_MESH_ORIENT": "4",
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RunConfig.from_env()
    assert (cfg.orient_block, cfg.kernel_img_tile, cfg.use_kernels, cfg.kernel_projection,
            cfg.fused_batched, cfg.fused_lse, cfg.autotune, cfg.checkpoint_path,
            cfg.checkpoint_every, cfg.profile_dir) == (
        16, 8, True, False, True, True, False, "c.npz", 4, "prof")
    assert cfg.forced == {"orient_block", "kernel_img_tile", "use_kernels",
                          "kernel_projection", "fused_batched", "fused_lse"}
    assert (cfg.mesh_images, cfg.mesh_orient) == (2, 4)


def _tiny_engine(rng, monkeypatch):
    """make_engine on a tiny problem with RunConfig.from_env, on the CPU."""
    from bioem_tpu_torch.run import make_engine

    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    p = tiny_params()
    return make_engine(p, build_orientations(p), tiny_model(rng),
                       tiny_images(rng, 3, p.n_pixels), RunConfig.from_env())


@pytest.mark.parametrize("name", ["BIOEM_TPU_MESH_IMAGES", "BIOEM_TPU_MESH_ORIENT",
                                  "BIOEM_TPU_NATIVE_IO", "BIOEM_TPU_COORDINATOR",
                                  "BIOEM_TPU_NUM_PROCESSES", "BIOEM_TPU_PROCESS_ID"])
def test_mesh_native_and_process_env_honoured(name, rng, tmp_path, monkeypatch):
    """The six names the port refused until the mesh, multi-process runs
    and the native ingest were ported are now parsed and honoured: a mesh
    side of 2 builds a two-slot mesh engine; BIOEM_TPU_NATIVE_IO=1 reads
    through the C++ reader and 0 through NumPy; one of the three
    multi-process names alone is a partial configuration, which
    initialize() (the CLI's first step) refuses."""
    from bioem_tpu_torch.parallel import distributed
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine
    from bioem_tpu_torch.runtime import native

    assert name in tconfig.HONOURED_ENV
    if name.startswith("BIOEM_TPU_MESH"):
        monkeypatch.setenv(name, "2")
        eng = _tiny_engine(rng, monkeypatch)
        assert isinstance(eng, ShardedBioEMEngine) and len(eng.slots) == 2
        assert eng.mesh.shape == ((2, 1) if name.endswith("IMAGES") else (1, 2))
    elif name == "BIOEM_TPU_NATIVE_IO":
        from bioem_tpu_torch.io.map_io import read_mrc_maps
        from bioem_tpu_torch.io.mrc import write_mrc

        path = str(tmp_path / "s.mrc")
        write_mrc(path, rng.normal(0, 1, (2, 8, 8)).astype(np.float32))
        before = native.calls["mrc_stack"]
        monkeypatch.setenv(name, "1")
        fast = read_mrc_maps(path, 8).maps
        assert native.calls["mrc_stack"] == before + 1
        monkeypatch.setenv(name, "0")
        assert native.get_lib() is None
        np.testing.assert_array_equal(read_mrc_maps(path, 8).maps, fast)
        assert native.calls["mrc_stack"] == before + 1
    else:
        value = {"BIOEM_TPU_COORDINATOR": "127.0.0.1:1", "BIOEM_TPU_NUM_PROCESSES": "2",
                 "BIOEM_TPU_PROCESS_ID": "0"}[name]
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=f"partial multi-process.*{value}"):
            distributed.initialize()
        assert not distributed.is_initialized()


@pytest.mark.parametrize("name,value", [("BIOEM_TPU_MESH_IMAGES", "1"),
                                        ("BIOEM_TPU_NATIVE_IO", "0"),
                                        *((n, "1") for n in sorted(tconfig.TPU_ONLY_ENV))])
def test_passing_and_tpu_only_env_do_not_refuse(name, value, rng, monkeypatch):
    """A 1×1 mesh, the NumPy readers and the TPU-only knobs all leave the
    run on the single-device engine of the default configuration."""
    monkeypatch.setenv(name, value)
    cfg = RunConfig.from_env()
    assert (cfg.mesh_images, cfg.mesh_orient, cfg.forced) == (1, 1, frozenset())
    assert type(_tiny_engine(rng, monkeypatch)) is BioEMEngine


# ---------------------------------------------------------------------------
# device: the card, or the CPU only when asked
# ---------------------------------------------------------------------------

def _no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BIOEM_TPU_FORCE_CPU", raising=False)


def test_resolve_device(monkeypatch):
    import torch

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match=r"device='cpu'.*BIOEM_TPU_FORCE_CPU=1"):
        tconfig.resolve_device()
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    assert tconfig.resolve_device() == torch.device("cpu")
    # the switch beats a card; an explicit device beats the switch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tconfig.resolve_device() == torch.device("cpu")
    assert tconfig.resolve_device("cuda:1") == torch.device("cuda:1")
    monkeypatch.delenv("BIOEM_TPU_FORCE_CPU")
    assert tconfig.resolve_device() == torch.device("cuda")


def test_entry_points_raise_without_card(rng, monkeypatch):
    """With no card and no switch, the engine, run_bioem, the autotuner and
    the CLI raise instead of running on the CPU; the CLI before it reads
    any input (the files named here do not exist)."""
    from bioem_tpu_torch import cli
    from bioem_tpu_torch.run import run_bioem

    p, model, images, orients = _problem(rng)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BioEMEngine(p, orients, model, images, RunConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_bioem(p, orients, model, images, RunConfig(autotune=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune_config(p, orients, model, images, RunConfig(),
                        candidates=[RunConfig(orient_block=1)], blocks=1, repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--Modelfile", "absent_model.txt", "--Particlesfile", "absent.txt",
                  "--Inputfile", "absent_param.txt"])


def test_force_cpu_is_honoured(rng, monkeypatch):
    """BIOEM_TPU_FORCE_CPU (the JAX package's switch) puts the engine and
    run_bioem on the CPU, on its plain branch."""
    from bioem_tpu_torch.run import run_bioem

    p, model, images, orients = _problem(rng)
    _no_card(monkeypatch)
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    assert "BIOEM_TPU_FORCE_CPU" in tconfig.HONOURED_ENV
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=2))
    assert eng.device.type == "cpu" and not eng.use_kernels
    res, perf = run_bioem(p, orients, model, images, RunConfig(orient_block=2, autotune=False))
    assert perf["device"] == "cpu" and perf["engine"].device.type == "cpu"
    np.testing.assert_array_equal(res.log_prob, eng.results(eng.run()).log_prob)
