"""The port's bank-swapping modes — image streaming (stream.py) and
multi-model ranking (rank.py) — against the JAX package's on the same
inputs, mirroring the single-process cases of tests/test_stream_rank.py.

Both reuse one engine through swapped banks: image chunks
(``swap_images``) and model arrays (``swap_model``, each model with its own
per-group point counts, which the projection kernel reads). Held to the
suite's logP tolerance (rtol 1e-9, atol 1e-7) with the argmax tuples
exact, against the JAX functions and against an independent port engine
per chunk or model. The streamed plain branch is not bit-equal to the
whole run on the CPU (the einsums' batch of images differs; measured
4.5e-8 at |logP| ≈ 300), so it is held to the same tolerance. The
sharded cases of tests/test_stream_rank.py are in tests/test_torch_sharding.py.
"""

import os

import numpy as np
import pytest

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.rank import rank_models as j_rank_models
from bioem_tpu.stream import ArraySource as JArraySource
from bioem_tpu.stream import run_streaming as j_run_streaming
from bioem_tpu_torch.config import RunConfig
from bioem_tpu_torch.core.engine import BioEMEngine
from bioem_tpu_torch.core.orientations import build_orientations
from bioem_tpu_torch.io.model_io import Model
from bioem_tpu_torch.rank import common_model_layout, format_ranking, rank_models
from bioem_tpu_torch.stream import ArraySource, MRCStackSource, run_streaming

from .conftest import tiny_images, tiny_model, tiny_params

SUITE = dict(rtol=1e-9, atol=1e-7)
ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")
CPU = "cpu"


def _engine(p, model, images, cfg, **kw):
    return BioEMEngine(p, build_orientations(p), model, images, cfg, device=CPU, **kw)


def _same(a, b, tol=SUITE):
    np.testing.assert_allclose(a.log_prob, b.log_prob, **tol)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


# ---------------------------------------------------------------------------
# Ranking (tests/test_stream_rank.py:20, :37, :59)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["plain", "kernel"])
def test_rank_matches_jax_and_independent_runs(rng, branch):
    """Three models (the second with fewer points, the third more per
    group than the first) ranked by one engine equal JAX's rank_models and
    an independent engine per model. On the kernel branch (the kernel
    wrappers' plain versions here) the projection reads each model's own
    per-group point counts: with the first model's counts the third
    model's extra points would be dropped."""
    p = tiny_params()
    models = [tiny_model(rng, n_points=12, with_radius=False), tiny_model(rng, n_points=9),
              tiny_model(rng, n_points=20, with_radius=False)]
    images = tiny_images(rng, 3, p.n_pixels)
    kw = dict(orient_block=2) if branch == "plain" else dict(
        orient_block=2, use_kernels=True, kernel_img_tile=3)
    cfg = RunConfig(**kw)
    total, per_image, perf = rank_models(p, build_orientations(p), models, images, cfg,
                                         device=CPU)
    assert total.shape == (3,) and per_image.shape == (3, 3) and perf["captures"] == 0
    total_j, per_image_j, _ = j_rank_models(p, j_orients(p), models, images,
                                            JConfig(orient_block=2))
    np.testing.assert_allclose(per_image, per_image_j, rtol=1e-9, atol=1.1e-5 if branch == "kernel"
                               else 1e-7)
    for m, model in enumerate(models):
        eng = _engine(p, model, images, cfg)
        np.testing.assert_allclose(per_image[m], eng.results(eng.run()).log_prob, **SUITE)
    # the third model has more points in its group than the first
    lay = common_model_layout(p, models)
    eng = _engine(p, models[0], images, cfg, model_layout=lay)
    c0, c2 = eng.banks.counts, eng.swap_model(models[2]).counts
    assert int(c2.max()) > int(c0.max()) and c2.shape == c0.shape


def test_rank_one_engine_swaps_models(rng):
    """tests/test_stream_rank.py:37: the models share one engine — the
    swapped banks keep every shape and dtype — and each model's pass
    through run(banks=…) equals that model's own engine."""
    p = tiny_params()
    orients = build_orientations(p)
    models = [tiny_model(rng, n_points=10), tiny_model(rng, n_points=7)]
    images = tiny_images(rng, 2, p.n_pixels)
    cfg = RunConfig(orient_block=2)
    layout = common_model_layout(p, models, cfg.projection)
    eng = BioEMEngine(p, orients, models[0], images, cfg, device=CPU, model_layout=layout)
    st0 = eng.run()
    banks1 = eng.swap_model(models[1])
    for a, b in zip(eng.banks, banks1):
        assert a.shape == b.shape and a.dtype == b.dtype
    r0, r1 = eng.results(st0), eng.results(eng.run(banks=banks1))
    assert not np.allclose(r0.log_prob, r1.log_prob)
    assert np.all(np.isfinite(r1.log_prob))
    own = _engine(p, models[1], images, cfg)
    _same(r1, own.results(own.run()))
    # the engine's own banks are untouched by the swap
    _same(eng.results(eng.run()), r0, dict(rtol=0, atol=0))


def test_rank_mixed_radius_layout(rng):
    """tests/test_stream_rank.py:59: a continuous-radius model forces the
    raster path for all candidates."""
    p = tiny_params()
    m1 = tiny_model(rng, n_points=8)
    m2 = tiny_model(rng, n_points=40)  # 40 distinct radii > MAX_RADIUS_GROUPS
    lay = common_model_layout(p, [m1, m2])
    assert lay.get("force_raster")
    images = tiny_images(rng, 2, p.n_pixels)
    cfg = RunConfig(orient_block=2)
    _, per_image, _ = rank_models(p, build_orientations(p), [m1, m2], images, cfg, device=CPU)
    _, per_image_j, _ = j_rank_models(p, j_orients(p), [m1, m2], images, JConfig(orient_block=2))
    np.testing.assert_allclose(per_image, per_image_j, **SUITE)
    for m, model in enumerate([m1, m2]):
        eng = _engine(p, model, images, cfg)
        np.testing.assert_allclose(per_image[m], eng.results(eng.run()).log_prob, **SUITE)


def test_swap_model_refuses_another_layout(rng):
    p = tiny_params()
    eng = _engine(p, tiny_model(rng, n_points=8, with_radius=False), tiny_images(rng, 2, 16),
                  RunConfig(orient_block=2))
    with pytest.raises(ValueError, match="common model_layout"):
        eng.swap_model(tiny_model(rng, n_points=12))


def test_rank_cli(tmp_path, monkeypatch):
    """python -m bioem_tpu_torch.rank on golden case A's files: the same
    model twice ranks equal, and the per-image lines equal the JAX CLI's."""
    import shutil

    from bioem_tpu.rank import main as j_main
    from bioem_tpu_torch.rank import main

    from .test_golden import DATA

    shutil.copytree(os.path.join(DATA, "case_a_euler_ctf"), tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BIOEM_TPU_FORCE_CPU", "1")
    argv = ["--Modelfile", "model.txt", "--Modelfile", "model.txt", "--Particlesfile",
            "maps.txt", "--Inputfile", "param.txt"]
    assert main(argv + ["--OutputFile", "rank_port"]) == 0
    assert j_main(argv + ["--OutputFile", "rank_jax"]) == 0
    ours = open("rank_port").read()
    theirs = open("rank_jax").read()
    rows = lambda s: [ln.split()[2:] for ln in s.splitlines() if ln.startswith("RefMap:")]  # noqa: E731
    a, b = np.array(rows(ours), float), np.array(rows(theirs), float)
    assert a.shape == b.shape and a.shape[1] == 2
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)  # 4 printed decimals
    np.testing.assert_array_equal(a[:, 0], a[:, 1])
    assert "#1 model.txt" in ours


def test_format_ranking_orders_by_total():
    out = format_ranking(np.array([-10.0, -5.0]), np.array([[-4.0, -6.0], [-2.0, -3.0]]),
                         ["a", "b"])
    assert out.index("#1 b") < out.index("#2 a")
    assert "a: 0, b: 2" in out


# ---------------------------------------------------------------------------
# Streaming (tests/test_stream_rank.py:77, :96, :172, :193, :254)
# ---------------------------------------------------------------------------

def test_streaming_matches_full_run_and_jax(rng):
    p = tiny_params()
    model = tiny_model(rng)
    images = tiny_images(rng, 7, p.n_pixels)  # 3 chunks of 3 (last short)
    cfg = RunConfig(orient_block=2)
    eng = _engine(p, model, images, cfg)
    full = eng.results(eng.run())
    res, perf = run_streaming(p, build_orientations(p), model, ArraySource(images.maps), cfg,
                              chunk_images=3, device=CPU)
    assert perf["chunks"] == 3 and perf["captures"] == 0
    assert perf["comparisons"] == 7 * eng.n_orient * eng.n_ctf
    _same(res, full)
    res_j, _ = j_run_streaming(p, j_orients(p), model, JArraySource(images.maps),
                               JConfig(orient_block=2), chunk_images=3)
    _same(res, res_j)


def test_streaming_write_angles(rng):
    p = tiny_params(write_angles=2)
    model = tiny_model(rng)
    images = tiny_images(rng, 5, p.n_pixels)
    cfg = RunConfig(orient_block=2)
    eng = _engine(p, model, images, cfg)
    full = eng.results(eng.run())
    res, _ = run_streaming(p, build_orientations(p), model, ArraySource(images.maps), cfg,
                           chunk_images=2, device=CPU)
    np.testing.assert_allclose(res.angle_log, full.angle_log, **SUITE)
    res_j, _ = j_run_streaming(p, j_orients(p), model, JArraySource(images.maps),
                               JConfig(orient_block=2), chunk_images=2)
    np.testing.assert_allclose(res.angle_log, res_j.angle_log, rtol=1e-9, atol=2.2e-6)


def test_run_on_swapped_images_equals_their_engine(rng):
    """run(banks=swap_images(other)) equals the engine built on ``other``
    (plain branch and, with the kernel wrappers' plain versions, the
    kernel branch)."""
    p = tiny_params()
    model = tiny_model(rng)
    images, other = tiny_images(rng, 4, p.n_pixels), tiny_images(rng, 4, p.n_pixels)
    for cfg in (RunConfig(orient_block=2),
                RunConfig(orient_block=2, use_kernels=True, kernel_img_tile=2)):
        eng = _engine(p, model, images, cfg)
        swapped = eng.results(eng.run(banks=eng.swap_images(other.maps)))
        own = _engine(p, model, other, cfg)
        _same(swapped, own.results(own.run()))


def test_run_with_swapped_banks_requires_bank_tag(rng, tmp_path):
    """tests/test_stream_rank.py:172: checkpointing swapped banks without
    an identity tag refuses."""
    p = tiny_params()
    model = tiny_model(rng)
    images = tiny_images(rng, 2, p.n_pixels)
    cfg = RunConfig(orient_block=2, checkpoint_path=str(tmp_path / "s.npz"), checkpoint_every=1)
    eng = _engine(p, model, images, cfg)
    banks2 = eng.swap_images(tiny_images(rng, 2, p.n_pixels).maps)
    with pytest.raises(ValueError, match="bank_tag"):
        eng.run(banks=banks2)


def test_swapped_banks_must_match_the_engine(rng):
    p = tiny_params()
    eng = _engine(p, tiny_model(rng), tiny_images(rng, 2, p.n_pixels), RunConfig(orient_block=2))
    with pytest.raises(ValueError, match="exceed engine capacity"):
        eng.swap_images(tiny_images(rng, 3, p.n_pixels).maps)
    with pytest.raises(ValueError, match="engine's own"):
        eng.run(banks=eng.banks._replace(amp=eng.banks.amp.clone()))


def test_dc_dominated_chunk_into_shortcut_engine_raises(rng):
    """The engine chose the f32 log1p shortcut and the fused
    comparison from its first images; a DC-dominated chunk swapped in must
    raise rather than run the wrong comparison (as the JAX engine does)."""
    p = tiny_params()
    images = tiny_images(rng, 2, p.n_pixels)
    eng = _engine(p, tiny_model(rng), images, RunConfig(orient_block=2))
    assert eng._f32_corr_ok
    dc = images.maps + np.float32(50.0)
    with pytest.raises(ValueError, match="DC-dominated"):
        eng.swap_images(dc)
    with pytest.raises(ValueError, match="DC-dominated"):
        run_streaming(p, build_orientations(p), tiny_model(rng),
                      ArraySource(np.concatenate([images.maps, dc])), RunConfig(orient_block=2),
                      chunk_images=2, device=CPU)


def test_streaming_checkpoint_chunk2_computes_not_loads(rng, tmp_path):
    """tests/test_stream_rank.py:193: chunk 2 with checkpointing computes
    its own result (per-chunk fingerprint and file), and a restarted
    streamed run resumes chunk-accurate."""
    p = tiny_params()
    model = tiny_model(rng)
    images = tiny_images(rng, 4, p.n_pixels)
    plain = _engine(p, model, images, RunConfig(orient_block=2))
    ref = plain.results(plain.run())
    ckpt = str(tmp_path / "stream.npz")
    cfg = RunConfig(orient_block=2, checkpoint_path=ckpt, checkpoint_every=1)
    orients = build_orientations(p)
    res, perf = run_streaming(p, orients, model, ArraySource(images.maps), cfg, chunk_images=2,
                              device=CPU)
    assert perf["chunks"] == 2
    assert os.path.exists(ckpt + ".chunk0") and os.path.exists(ckpt + ".chunk1")
    _same(res, ref)
    res_j, _ = j_run_streaming(p, j_orients(p), model, JArraySource(images.maps),
                               JConfig(orient_block=2, checkpoint_path=str(tmp_path / "j.npz"),
                                       checkpoint_every=1), chunk_images=2)
    _same(res, res_j)
    res2, _ = run_streaming(p, orients, model, ArraySource(images.maps), cfg, chunk_images=2,
                            device=CPU)
    np.testing.assert_array_equal(res2.log_prob, res.log_prob)


def test_mrc_stack_source_chunks(rng, tmp_path):
    from bioem_tpu_torch.io.map_io import read_mrc_maps
    from bioem_tpu_torch.io.mrc import write_mrc

    maps = rng.normal(0, 1, (5, 8, 8)).astype(np.float32)
    path = str(tmp_path / "stack.mrc")
    write_mrc(path, maps)
    ref = read_mrc_maps(path, 8).maps
    src = MRCStackSource(path, 8)
    assert src.n_images == 5
    got = np.concatenate([src.chunk(0, 2), src.chunk(2, 5)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_model_layout_pads_the_raster(rng):
    """A raster layout pads the model's points with zero density: the
    padded engine equals the unpadded one."""
    p = tiny_params()
    model = tiny_model(rng, n_points=8)
    images = tiny_images(rng, 2, p.n_pixels)
    cfg = RunConfig(orient_block=2, projection="raster")
    padded = _engine(p, model, images, cfg, model_layout={"n_points_pad": 13, "stencil_half": 4})
    assert padded.banks.points.shape[0] == 13 and padded.spec.stencil_half == 4
    own = _engine(p, model, images, cfg)
    _same(padded.results(padded.run()), own.results(own.run()))
    with pytest.raises(ValueError, match="layout pad"):
        padded.swap_model(Model(*(np.repeat(x, 2, 0) if np.ndim(x) else x for x in (
            model.points, model.radii, model.densities, model.norm_den))))
