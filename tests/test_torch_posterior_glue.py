"""The block step's posterior glue (ops/posterior_cuda.py, G1 and G2) against
the JAX package, on the CPU.

On CPU tensors the wrappers run their plain torch versions (the card tests
in tests/test_torch_cuda.py hold the kernels to them). Inputs are made from
a numpy seed at a small size and handed to both packages.

* G1 ``block_constants``: sum_c and ssq_c against
  ``bioem_tpu.core.posterior.convolution_sums`` on the explicit conv (rtol
  1e-6: f32 sums in another order); F0 and K against ``logpro_constants``
  on G1's own sums (the JAX suite's logP tolerance, rtol 1e-9 / atol 1e-7),
  masked orientations exactly −inf; a_u and b_u against the JAX engine's
  expressions (bioem_tpu/core/engine.py:553-560) at rtol 1e-6 (f32; the
  port's b_u is a reciprocal and a product, JAX's one division).
* G2 ``merge_block``: the state after three blocks against the JAX
  ``refine_varying_max`` and ``merge_block`` — the f64 fields (const,
  best_norm, best_mu, the slabs' const) at rtol 1e-9 / atol 1e-7, argmax
  tuples exact, total and the slabs' total at rtol 1e-6: each is a sum of
  f32 products se·expf(f32 difference), and XLA's f32 exp and summation
  order differ from torch's by an f32 rounding (measured up to 1.3e-7 of
  total here) — on a partially masked block, a fully masked one, exact
  ties between (o, c) pairs, the hybrid's given f32 m, slabs on and off;
  an int offset and a 0-d tensor offset give the same bits.
* G1's plan on the card (``constants_plan``: chunks, staging passes,
  workers) covers every column and pair within its limits, and a NumPy
  model of the kernel's fixed-order f64 reduction (phase 1 lanes, chunk
  partials, the workers' lanes) lies within one f32 ulp of f64 truth and
  of a model of PR 14's order; the wrappers' checks that need no card.
* The engine: a kernel-branch block step through G1 and G2 equals, bit for
  bit, the composition of torch functions the engine called before them,
  reading the lattice weights' columns the engine holds (``wx_cols``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bioem_tpu.core.posterior as J
import bioem_tpu_torch.core.posterior as T
from bioem_tpu_torch.convert import state_to_numpy
from bioem_tpu_torch.ops import posterior_cuda as G

from .conftest import tiny_images, tiny_model, tiny_params

SUITE = dict(rtol=1e-9, atol=1e-7)
F32 = np.float32


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def _spectra(rng, o=3, c=4, i=6, n=16, normalized=True):
    """G1's inputs: spectra, Hermitian weights, image sums, prior, mask."""
    f = n // 2 + 1
    r = lambda *s: rng.normal(0, 1, s).astype(F32)  # noqa: E731
    sum_ref = (rng.normal(0, 0.1, i) if normalized else rng.normal(50, 5, i)).astype(F32)
    ssq_ref = (rng.uniform(200, 300, i) if normalized
               else sum_ref.astype(np.float64) ** 2 / (n * n) + rng.uniform(200, 300, i)).astype(F32)
    mask = np.ones(o, np.int32)
    mask[-1] = 0
    return dict(pr=r(o, n, f), pi=r(o, n, f), ctf_re=r(c, n, f), ctf_im=r(c, n, f),
                h=T.hermitian_weights(n), sum_ref=sum_ref, ssq_ref=ssq_ref,
                prior=rng.normal(0, 1, c), mask=mask)


def _g1(x, normalized, n=16):
    keys = ("pr", "pi", "ctf_re", "ctf_im", "h", "sum_ref", "ssq_ref", "prior", "mask")
    return G.block_constants(*(t(x[k]) for k in keys), ntot=float(n * n),
                             images_normalized=normalized)


@pytest.mark.parametrize("normalized", [True, False])
def test_block_constants_sums_match_jax(rng, normalized):
    x = _spectra(rng, normalized=normalized)
    sum_c, ssq_c = _g1(x, normalized)[:2]
    pr, pi, cr, ci = (x[k][:, None] if k[0] == "p" else x[k][None]
                      for k in ("pr", "pi", "ctf_re", "ctf_im"))
    js, jss = J.convolution_sums(j(pr * cr + pi * ci), j(pi * cr - pr * ci), j(x["h"]), 16)
    assert sum_c.dtype == ssq_c.dtype == torch.float32 and sum_c.shape == (3, 4)
    np.testing.assert_allclose(sum_c.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(ssq_c.numpy(), np.asarray(jss), rtol=1e-6)


@pytest.mark.parametrize("normalized", [True, False])
def test_block_constants_f0_k_match_jax(rng, normalized):
    """F0 and K on G1's own sums; the masked orientation's K is −inf and
    its F0 unchanged."""
    x = _spectra(rng, normalized=normalized)
    sum_c, ssq_c, f0, k, _a_u, _b_u = _g1(x, normalized)
    prior = np.broadcast_to(x["prior"][None], sum_c.shape)
    jf0, jk = J.logpro_constants(j(sum_c), j(ssq_c), j(x["sum_ref"]), j(x["ssq_ref"]),
                                 j(prior), 256.0, images_normalized=normalized)
    assert f0.dtype == k.dtype == torch.float64 and f0.shape == (3, 4, 6)
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), **SUITE)
    live = x["mask"] != 0
    np.testing.assert_allclose(k.numpy()[live], np.asarray(jk)[live], **SUITE)
    assert np.all(k.numpy()[~live] == -np.inf) and np.isfinite(k.numpy()[live]).all()


@pytest.mark.parametrize("normalized", [True, False])
def test_block_constants_coefficients_match_jax(rng, normalized):
    x = _spectra(rng, normalized=normalized)
    sum_c, _ssq_c, f0, _k, a_u, b_u = _g1(x, normalized)
    f0_32 = j(f0).astype(jnp.float32)
    ja = (2.0 * j(x["sum_ref"])[None, None, :] * j(sum_c)[:, :, None] / f0_32).astype(jnp.float32)
    jb = jnp.float32(256.0) / f0_32
    assert a_u.dtype == b_u.dtype == torch.float32 and a_u.shape == (12, 6)
    np.testing.assert_allclose(a_u.numpy(), np.asarray(ja).reshape(12, 6), rtol=1e-6)
    np.testing.assert_allclose(b_u.numpy(), np.asarray(jb).reshape(12, 6), rtol=1e-6)


def test_block_constants_wrapper_runs_the_plain_version_on_cpu(rng):
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing."""
    x = _spectra(rng)
    keys = ("pr", "pi", "ctf_re", "ctf_im", "h", "sum_ref", "ssq_ref", "prior", "mask")
    before = G.block_constants.launches
    got = _g1(x, True)
    want = G.block_constants_plain(*(t(x[k]) for k in keys), ntot=256.0, images_normalized=True)
    assert G.block_constants.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------

def _merge_block_inputs(rng, case, o=2, c=3, i=5, d=5):
    """One block's merge inputs from G1's constants on random spectra:
    (m or None, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp)."""
    x = _spectra(rng, o=o, c=c, i=i)
    x["mask"][:] = 1
    if case == "partial":
        x["mask"][1] = 0
    elif case == "full":
        x["mask"][:] = 0
    sum_c, ssq_c, f0, k, _a, _b = (v.numpy() for v in _g1(x, True))
    se = rng.uniform(1, 3, (o, c, i)).astype(F32)
    ds = rng.integers(0, d * d, (o, c, i)).astype(np.int32)
    ccs = rng.normal(0, 1, (o, c, i)).astype(F32)
    m = rng.normal(-5, 1, (o, c, i)).astype(F32) if case == "hybrid" else None
    if case == "ties":
        # pairs 0, 3 and 4 (flat o·C + c) equal and largest on every image:
        # the first occurrence must win over pairs with other tuples
        k = k.copy()
        k.reshape(o * c, i)[0] += 1e4
        for q in (3, 4):
            for a in (k, f0, ccs):
                a.reshape(o * c, i)[q] = a.reshape(o * c, i)[0]
            sum_c.reshape(-1)[q] = sum_c.reshape(-1)[0]
    disp = (np.arange(d) - d // 2).astype(np.int32)
    return m, se, ds, ccs, k, f0, sum_c, ssq_c, x["sum_ref"], disp


MERGE_CASES = ("live", "partial", "full", "ties", "hybrid")


def _merged(rng, case, write_angles, offset=int):
    """Three blocks of two orientations into a state of six, the middle
    one ``case``, through the JAX package and through G2."""
    o, n_orient, d = 2, 6, 5
    sj = J.init_state(5, n_orient, write_angles)
    st = T.init_state(5, n_orient, write_angles)
    for blk, cs in enumerate(("live", case, "live")):
        m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp = _merge_block_inputs(rng, cs)
        jm = (J.refine_varying_max(j(ccs), j(sum_c), j(sum_ref), j(f0), 256.0) if m is None
              else j(m))
        sj = J.merge_block(sj, jm, j(se), j(ds), j(ccs), j(k), j(sum_c), j(ssq_c), j(sum_ref),
                           j(disp), jnp.int32(blk * o), 256.0, d)
        st = G.merge_block(st, None if m is None else t(m), t(se), t(ds), t(ccs), t(k), t(f0),
                           t(sum_c), t(ssq_c), t(sum_ref), t(disp), offset(blk * o), ntot=256.0)
    return sj, st


@pytest.mark.parametrize("write_angles", [False, True])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_block_matches_jax(rng, case, write_angles):
    sj, st = _merged(rng, case, write_angles)
    got = state_to_numpy(st)
    want = {key: None if v is None else np.asarray(v) for key, v in sj._asdict().items()}
    for key, v in want.items():
        assert (got[key] is None) == (v is None), key
        if v is None:
            continue
        assert got[key].dtype == v.dtype, key
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        elif key in ("total", "ang_total"):
            np.testing.assert_allclose(got[key], v, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], v, **SUITE, err_msg=key)
    assert np.isfinite(got["total"]).all() and (got["total"] > 0).all()
    if case == "ties":  # the first of the tied pairs: orientation 2, CTF 0
        assert (got["best_orient"] == 2).all() and (got["best_conv"] == 0).all()


def test_fully_masked_block_leaves_the_state_as_it_was(rng):
    """A fully masked block (k −inf everywhere) changes no bit of the state,
    slabs included."""
    o = 2
    st = T.init_state(5, 6, True)
    args = [t(a) if a is not None else None for a in _merge_block_inputs(rng, "live")]
    G.merge_block(st, *args, 0, ntot=256.0)
    before = [x.clone() for x in st]
    args = [t(a) if a is not None else None for a in _merge_block_inputs(rng, "full")]
    G.merge_block(st, *args, o, ntot=256.0)
    assert all(torch.equal(a, b) for a, b in zip(st, before))


@pytest.mark.parametrize("write_angles", [False, True])
@pytest.mark.parametrize("case", ["live", "hybrid"])
def test_merge_block_int_and_tensor_offsets_are_bit_equal(rng, case, write_angles):
    """An int offset and a 0-d int64 tensor (what a captured block step
    passes) give the same bits, ang_offset given apart too."""
    seed = int(rng.integers(1 << 30))
    _sj, a = _merged(np.random.default_rng(seed), case, write_angles)
    _sj, b = _merged(np.random.default_rng(seed), case, write_angles,
                     offset=lambda v: torch.tensor(v, dtype=torch.int64))
    for key, x, y in zip(T.PosteriorState._fields, a, b):
        assert (x is None) == (y is None), key
        assert x is None or torch.equal(x, y), key
    st = [T.init_state(5, 2, write_angles) for _ in range(2)]
    args = [t(v) if v is not None else None for v in _merge_block_inputs(rng, case)]
    G.merge_block(st[0], *args, 4, ntot=256.0, ang_offset=0)
    G.merge_block(st[1], *args, torch.tensor(4), ntot=256.0, ang_offset=torch.tensor(0))
    assert all(x is None or torch.equal(x, y) for x, y in zip(*st))


@pytest.mark.parametrize("ang_offset", [-1, 5])
def test_merge_block_slab_outside_raises(rng, ang_offset):
    """A block whose slab columns ang_offset + o leave the slab raises
    (index_select's contract, which the card's wrapper checks eagerly for
    an int offset) and adds nothing to the state."""
    st = T.init_state(5, 6, True)
    before = [x.clone() for x in st]
    args = [t(v) if v is not None else None for v in _merge_block_inputs(rng, "live")]
    with pytest.raises((IndexError, RuntimeError)):  # torch's kind depends on the side
        G.merge_block(st, *args, 0, ntot=256.0, ang_offset=ang_offset)
    assert torch.equal(st.ang_total, before[8]) and torch.equal(st.ang_const, before[9])


@pytest.mark.parametrize("case", ["live", "hybrid"])
def test_merge_block_m_out(rng, case):
    """m_out receives the varying max the merge used: the f64 repair
    (refine_varying_max) on the fused path, the given m otherwise."""
    m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp = (
        t(v) if v is not None else None for v in _merge_block_inputs(rng, case))
    out = torch.empty(k.shape, dtype=torch.float64)
    G.merge_block(T.init_state(5, 2, False), m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp,
                  0, ntot=256.0, m_out=out)
    want = (T.refine_varying_max(ccs, sum_c, sum_ref, f0, 256.0) if m is None
            else m.to(torch.float64))
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _old_kernel_step(eng, state, banks, angles, orient_offset, mask):
    """The kernel branch's block step as the engine composed it from torch
    functions before G1 and G2."""
    from bioem_tpu_torch.ops import compare_cuda as C

    p = eng.p
    n, ntot = p.n_pixels, p.n_total_pixels
    o, c, d = eng.o_block, eng.n_ctf, eng.disp.shape[0]
    i_n = banks.img_re.shape[0]
    pr, pi = eng._project_block(banks, angles)
    prior_oc = eng._prior[None, :].expand(o, c)
    mag_p = (pr * pr + pi * pi) * banks.h[None, None, :]
    mag_c = banks.ctf_re**2 + banks.ctf_im**2
    ssq_c = torch.matmul(mag_p.reshape(o, -1), mag_c.reshape(c, -1).T) / float(ntot)
    sum_c = (pr[:, 0, 0, None] * banks.ctf_re[None, :, 0, 0]
             + pi[:, 0, 0, None] * banks.ctf_im[None, :, 0, 0])
    f0, k = T.logpro_constants(sum_c, ssq_c, banks.sum_ref, banks.ssq_ref, prior_oc, ntot,
                               images_normalized=eng._f32_corr_ok)
    m_cols = n // eng.n_fold
    wx = (banks.wx_re[:, :m_cols].contiguous(), banks.wx_im[:, :m_cols].contiguous())
    if eng.fused_lse and eng._f32_corr_ok:
        f0_32 = f0.to(torch.float32)
        a_u = (2.0 * banks.sum_ref[None, None, :] * sum_c[:, :, None] / f0_32).to(torch.float32)
        b_u = float(np.float32(ntot)) / f0_32
        fn, kw = ((C.fused_compare_block_batched, dict(img_tile=eng.i_block)) if eng.fused_batched
                  else (C.fused_compare_block, {}))
        _m, se, ds, ccs = fn(pr, pi, banks.ctf_re, banks.ctf_im, banks.img_re, banks.img_im, *wx,
                             banks.wy_re, banks.wy_im, a_u.reshape(o * c, i_n),
                             b_u.reshape(o * c, i_n), a_coef=(3.0 - ntot) * 0.5,
                             n_fold=eng.n_fold, **kw)
        se, ds, ccs = (v.reshape(o, c, i_n) for v in (se, ds, ccs))
        m = T.refine_varying_max(ccs, sum_c, banks.sum_ref, f0, ntot)
    else:
        conv_re = pr[:, None] * banks.ctf_re[None] + pi[:, None] * banks.ctf_im[None]
        conv_im = pi[:, None] * banks.ctf_re[None] - pr[:, None] * banks.ctf_im[None]
        cc = C.fused_displacement_cc(
            conv_re.reshape(o * c, n, p.n_fft_1d), conv_im.reshape(o * c, n, p.n_fft_1d),
            banks.img_re, banks.img_im, *wx, banks.wy_re, banks.wy_im, n_fold=eng.n_fold,
        ).reshape(o, c, i_n, d, d)
        m, se, ds, ccs = T.displacement_lse(cc, sum_c, banks.sum_ref, f0, ntot,
                                            f32_u=eng._f32_corr_ok, ssq_c=ssq_c,
                                            ssq_ref=banks.ssq_ref)
    k = torch.where(mask[:, None, None] != 0, k, torch.full_like(k, -torch.inf))
    return T.merge_block(state, m, se, ds, ccs, k, sum_c, ssq_c, banks.sum_ref, banks.disp,
                         orient_offset, ntot, d)


ENGINE_PATHS = {
    # name: (params, dc offset, port cfg)
    "k1": ({}, 0.0, {}),
    "k4": ({}, 0.0, dict(fused_batched=True, kernel_img_tile=5)),
    "hybrid": ({}, 0.0, dict(fused_lse=False)),
    "hybrid_dc": (dict(no_map_norm=True), 3.0, {}),
}


@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_engine_kernel_step_equals_the_old_composition(rng, path):
    """Every block of a padded pass with per-angle slabs, through G1 and G2
    on the CPU, against the torch composition they replace: the same state,
    bit for bit. The step reads the lattice weights' columns the engine
    holds (contiguous copies made once): on banks whose wx is poisoned with
    NaN it still equals the old composition on the engine's own banks."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.core.orientations import build_orientations

    pkw, dc, cfg = ENGINE_PATHS[path]
    p = tiny_params(max_displace_center=4, grid_space_center=2, write_angles=3, **pkw)
    images = tiny_images(rng, 5, p.n_pixels)
    images.maps[:] += np.float32(dc)
    eng = BioEMEngine(p, build_orientations(p), tiny_model(rng), images,
                      RunConfig(use_kernels=True, orient_block=3, **cfg), device="cpu")
    assert eng.n_orient_pad > eng.n_orient and eng.fused_batched == (path == "k4")
    assert eng._f32_corr_ok == (path != "hybrid_dc")
    m_cols = p.n_pixels // eng.n_fold
    for held, full in zip(eng.wx_cols, (eng.banks.wx_re, eng.banks.wx_im)):
        assert held.is_contiguous() and torch.equal(held, full[:, :m_cols])
    assert eng._g1_workspace is None  # the card's scratch only
    poisoned = eng.banks._replace(wx_re=torch.full_like(eng.banks.wx_re, torch.nan),
                                  wx_im=torch.full_like(eng.banks.wx_im, torch.nan))
    new, old = eng.initial_state(), eng.initial_state()
    before = (G.block_constants.launches, G.merge_block.launches)
    for b in range(eng.ang_blocks.shape[0]):
        args = (eng.ang_blocks[b], b * eng.o_block, eng.mask_blocks[b])
        eng._block_step(new, poisoned, *args)
        _old_kernel_step(eng, old, eng.banks, *args)
    assert (G.block_constants.launches, G.merge_block.launches) == before
    for key, a, b in zip(T.PosteriorState._fields, new, old):
        assert a is not None and torch.equal(a, b), key


def test_the_capture_counts_g1_and_g2():
    """The engine's capture counts the glue kernels' launches per replay."""
    from bioem_tpu_torch.core.engine import _kernel_wrappers

    assert G.block_constants in _kernel_wrappers() and G.merge_block in _kernel_wrappers()


# ---------------------------------------------------------------------------
# G1's plan and its fixed-order reduction
# ---------------------------------------------------------------------------

# (O, C, I, N, SMs): the production block on an H100, o_block 16, a
# reference-grid block, one image, a tiny block, many images, O·C = 512,
# a card with fewer SMs than the production block has pairs per worker
PLAN_CASES = [(8, 8, 64, 224, 132), (16, 8, 64, 224, 132), (8, 32, 64, 224, 132),
              (8, 8, 1, 224, 132), (3, 4, 6, 16, 132), (8, 8, 1024, 224, 132),
              (16, 32, 64, 224, 132), (32, 32, 64, 224, 4), (5, 7, 3, 15, 1)]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_constants_plan_covers_every_column_and_pair(case):
    o, c, i, n, n_sm = case
    f = n // 2 + 1
    nf, p = n * f, o * c
    plan = G.constants_plan(o, c, i, n, f, n_sm)
    assert 1 <= plan.grid <= n_sm
    assert plan.grid * plan.chunk >= nf > (plan.grid - 1) * plan.chunk  # no CTA idle
    assert plan.chunk >= min(G.G1_MIN_CHUNK, nf)
    assert 1 <= plan.sub <= plan.chunk and (16 * (o + c) + 8) * plan.sub <= G.G1_STAGE_BYTES
    assert 1 <= plan.workers <= plan.grid
    assert plan.workers * plan.per_worker >= p > (plan.workers - 1) * plan.per_worker
    assert plan.ws_doubles == plan.grid * p + 2 * i
    if plan.workers < plan.grid:  # about one (o, c, i) entry per worker thread
        assert plan.per_worker == min(max(G.G1_THREADS // max(i, 1), 1), p)


def test_constants_plan_of_the_production_block():
    """One CTA per SM of 192 columns, staged in one pass; 8 workers of 8
    pairs, each one entry per thread."""
    assert G.constants_plan(8, 8, 64, 224, 113, 132) == G.ConstantsPlan(132, 192, 192, 8, 8,
                                                                         132 * 64 + 128)


@pytest.mark.parametrize("bad", [(0, 8, 64, 224, 113, 132), (8, 8, -1, 224, 113, 132),
                                 (8, 8, 64, 224, 113, 0), (6000, 6000, 4, 16, 9, 132)])
def test_constants_plan_refuses_what_it_cannot_take(bad):
    with pytest.raises(ValueError, match="block_constants"):
        G.constants_plan(*bad)


def _terms(rng, o, c, n):
    """G1's (O·C, N·F) f64 terms |p|²·h·|ctf|², each rounded as the kernel
    rounds it, from f32 spectra made from ``rng``."""
    f = n // 2 + 1
    sp = [rng.normal(0, 1, (k, n * f)).astype(F32).astype(np.float64) for k in (o, o, c, c)]
    h = np.tile(T.hermitian_weights(n).astype(F32).astype(np.float64), n)
    mp = (sp[0] * sp[0] + sp[1] * sp[1]) * h
    mc = sp[2] * sp[2] + sp[3] * sp[3]
    return (mp[:, None, :] * mc[None, :, :]).reshape(o * c, n * f)


def _pair_lanes(n, threads=512):
    """csrc/posterior_glue.cu pair_lanes: threads per pair, a power of 2 of
    at most 32 such that n pairs fit ``threads``."""
    lanes = 1
    while lanes < 32 and 2 * lanes * n <= threads:
        lanes *= 2
    return lanes


def _butterfly(v):
    """Lane 0's sum of v (lanes, ...) by csrc/posterior_glue.cu lanes_sum:
    at each step every lane adds the lane ``off`` away."""
    lanes = v.shape[0]
    off = lanes // 2
    while off:
        v = v + v[np.arange(lanes) ^ off]
        off //= 2
    return v[0]


def _kernel_order_sum(v, plan, threads=512):
    """A NumPy model of G1's f64 reduction over v (P, N·F), in the kernel's
    order (csrc/posterior_glue.cu): per CTA, ``lanes`` threads per pair each
    add a strided share of the chunk's columns (staging pass by staging
    pass), the lanes in order; then each worker's tile of pairs, ``nl``
    lanes per pair each adding the CTAs' partials strided, then a butterfly
    over the lanes. (P ≤ threads: one pair pass.)"""
    p, nf = v.shape
    lanes = threads // p
    parts = np.zeros((plan.grid, p))
    for b in range(plan.grid):
        j0, j1 = b * plan.chunk, min((b + 1) * plan.chunk, nf)
        acc = np.zeros((lanes, p))
        for s0 in range(j0, j1, plan.sub):
            ln = min(plan.sub, j1 - s0)
            for lane in range(lanes):
                for jj in range(lane, ln, lanes):
                    acc[lane] = acc[lane] + v[:, s0 + jj]
        tot = acc[0]
        for lane in range(1, lanes):
            tot = tot + acc[lane]
        parts[b] = tot
    out = np.zeros(p)
    for w in range(plan.workers):
        q0, q1 = w * plan.per_worker, min((w + 1) * plan.per_worker, p)
        nl = _pair_lanes(q1 - q0, threads)
        acc = np.zeros((nl, q1 - q0))
        for lane in range(nl):
            for cb in range(lane, plan.grid, nl):
                acc[lane] = acc[lane] + parts[cb, q0:q1]
        out[q0:q1] = _butterfly(acc)
    return out


def _strided_order_sum(v, threads=512):
    """PR 14's order (one CTA per pair): thread t adds columns t, t + 512,
    ...; the warps' butterflies; the 16 warp sums in order."""
    p, nf = v.shape
    acc = np.zeros((threads, p))
    for j in range(nf):
        acc[j % threads] = acc[j % threads] + v[:, j]
    warps = [_butterfly(acc[32 * w:32 * w + 32]) for w in range(threads // 32)]
    tot = warps[0]
    for x in warps[1:]:
        tot = tot + x
    return tot


def _f32_ulps(a, b):
    ia, ib = (np.asarray(x, F32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(ia - ib)


@pytest.mark.parametrize("case", [(3, 4, 16, 132), (8, 8, 32, 7), (5, 3, 33, 132)])
def test_fixed_order_reduction_model_against_f64_truth(rng, case):
    """ssq_c as G1 rounds it (the f64 sum in the kernel's order, divided by
    ntot, rounded to f32 once) lies within one f32 ulp of f64 truth (an
    exactly rounded sum, math.fsum) and of PR 14's order, and the model
    gives the same bits every time (the order is fixed by the plan)."""
    import math

    o, c, n, n_sm = case
    f = n // 2 + 1
    ntot = float(n * n)
    v = _terms(rng, o, c, n)
    plan = G.constants_plan(o, c, 1, n, f, n_sm)
    ours = _kernel_order_sum(v, plan)
    assert np.array_equal(ours, _kernel_order_sum(v, plan))
    truth = np.array([math.fsum(row) for row in v])
    np.testing.assert_allclose(ours, truth, rtol=1e-13, atol=0)
    assert _f32_ulps(ours / ntot, truth / ntot).max() <= 1
    assert _f32_ulps(ours / ntot, _strided_order_sum(v) / ntot).max() <= 1


def test_glue_wrappers_check_without_a_card(rng):
    """What the wrappers refuse before any launch: a G1 or G2 launch off the
    card, a workspace for other shapes, a workspace off the card and a block
    whose pairs do not fit G2's shared memory."""
    x = _spectra(rng)
    keys = ("pr", "pi", "ctf_re", "ctf_im", "h", "sum_ref", "ssq_ref", "prior", "mask")
    args = tuple(t(x[k]) for k in keys)
    with pytest.raises(ValueError, match="unsupported device"):
        G.constants_call("block_constants", args, 256.0, True)
    with pytest.raises(ValueError, match="workspace lies on the card"):
        G.constants_workspace(3, 4, 6, 16, 9, "cpu")
    ws = G.ConstantsWorkspace((3, 4, 5, 16, 9), G.constants_plan(3, 4, 5, 16, 9, 132),
                              torch.zeros(1, dtype=torch.float64), torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="workspace was made for"):
        G.check_workspace("block_constants", ws, (3, 4, 6, 16, 9), torch.device("cpu"))
    G.check_workspace("block_constants", ws, (3, 4, 5, 16, 9), torch.device("cpu"))
    m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp = (
        t(v) if v is not None else None for v in _merge_block_inputs(rng, "live"))
    state = T.init_state(5, 2, False)
    with pytest.raises(ValueError, match="unsupported device"):
        G.merge_call("merge_block", state, m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp, 0,
                     ntot=256.0)
    big = torch.zeros((100, 200, 5))
    with pytest.raises(ValueError, match="shared memory"):
        G.merge_call("merge_block", state, None, big, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp,
                     0, ntot=256.0)


def test_sass_counts_read_calls_and_local_memory():
    """kernel_probe.sass_counts_of: per kernel named by a stem, the CALLs and
    the local-memory stores and loads of cuobjdump's SASS listing."""
    from bioem_tpu_torch.tools.kernel_probe import sass_counts_of

    text = ("\tcode for sm_90a\n\t\tFunction : _Z18merge_block_kernelv\n"
            "  /*0010*/ STL.64 [R1], R4 ;\n  /*0020*/ CALL.REL.NOINC 0x100 ;\n"
            "  /*0030*/ LDL.64 R4, [R1] ;\n  /*0040*/ STL [R1+0x8], R2 ;\n"
            "\t\tFunction : _Z14other_kernelv\n  /*0010*/ CALL.ABS.NOINC 0x0 ;\n")
    assert sass_counts_of(text, ("merge_block_kernel", "absent")) == {
        "merge_block_kernel": {"calls": 1, "local stores": 2, "local loads": 1}}
