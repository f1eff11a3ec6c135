"""core/posterior.py of the port against bioem_tpu.core.posterior.

Each function gets the same inputs, made from a numpy seed, on both sides.
Tolerances: f64 paths agree to ~1e-12 relative (same formula, same
operation order); f32 contractions to the f32 rounding floor of a
different summation order (rtol 1e-5 on cc-scale values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bioem_tpu.core.posterior as J
import bioem_tpu_torch.core.posterior as T
from bioem_tpu_torch.convert import state_from_numpy, state_to_numpy

from .conftest import tiny_params


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("n", [15, 16, 224])
def test_host_constants(n):
    np.testing.assert_array_equal(J.hermitian_weights(n), T.hermitian_weights(n))
    disp = np.arange(-4, 5, 2)
    for a, b in zip(J.displacement_dft_weights(n, disp), T.displacement_dft_weights(n, disp)):
        np.testing.assert_array_equal(a, b)
    for s, d in ((2, disp), (3, np.array([0, 3, -5, -2])), (1, disp)):
        assert J.stride_fold(s, n, d) == T.stride_fold(s, n, d)


def test_convolution_sums(rng):
    cr = rng.normal(0, 1, (2, 3, 16, 9)).astype(np.float32)
    ci = rng.normal(0, 1, (2, 3, 16, 9)).astype(np.float32)
    h = J.hermitian_weights(16)
    for a, b in zip(J.convolution_sums(j(cr), j(ci), j(h), 16),
                    T.convolution_sums(t(cr), t(ci), t(h), 16)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        assert b.dtype == torch.float32


@pytest.mark.parametrize("use_psf", [False, True])
def test_ctf_prior_term(rng, use_psf):
    p = tiny_params(use_psf=use_psf) if use_psf else tiny_params()
    amp, pha, env = (rng.uniform(0.1, 2.0, 6).astype(np.float32) for _ in range(3))
    a = J.ctf_prior_term(j(amp), j(pha), j(env), p)
    b = T.ctf_prior_term(t(amp), t(pha), t(env), p)
    assert b.dtype == torch.float64
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13)


def _sums(rng, o=2, c=3, i=5, normalized=True):
    sum_c = rng.normal(5, 1, (o, c)).astype(np.float32)
    ssq_c = rng.uniform(50, 80, (o, c)).astype(np.float32)
    if normalized:
        sum_ref = rng.normal(0, 1e-4, i).astype(np.float32)
    else:
        sum_ref = rng.normal(40, 5, i).astype(np.float32)
    ssq_ref = rng.uniform(240, 270, i).astype(np.float32)
    prior = rng.normal(0, 1, (o, c))
    return sum_c, ssq_c, sum_ref, ssq_ref, prior


@pytest.mark.parametrize("normalized", [True, False])
def test_logpro_constants(rng, normalized):
    args = _sums(rng, normalized=normalized)
    a = J.logpro_constants(*(j(x) for x in args), 256.0, images_normalized=normalized)
    b = T.logpro_constants(*(t(x) for x in args), 256.0, images_normalized=normalized)
    for x, y in zip(a, b):
        assert y.dtype == torch.float64 and tuple(y.shape) == (2, 3, 5)
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-12)


def _cc_inputs(rng, o=2, c=2, i=3, n=12, d=5):
    f = n // 2 + 1
    disp = np.arange(d) - d // 2
    wx, wy = J.displacement_dft_weights(n, disp)
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return (r(o, c, n, f), r(o, c, n, f), r(i, n, f), r(i, n, f),
            wx.real.copy(), wx.imag.copy(), wy.real.copy(), wy.imag.copy())


def test_displacement_cc(rng):
    args = _cc_inputs(rng)
    a = np.asarray(J.displacement_cc(*(j(x) for x in args)))
    b = T.displacement_cc(*(t(x) for x in args)).numpy()
    assert b.shape == a.shape == (2, 2, 3, 5, 5)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())


def test_refine_varying_max(rng):
    sum_c, ssq_c, sum_ref, ssq_ref, prior = _sums(rng)
    f0, _ = J.logpro_constants(j(sum_c), j(ssq_c), j(sum_ref), j(ssq_ref), j(prior),
                               256.0, images_normalized=True)
    cc = rng.normal(0, 0.3, (2, 3, 5)).astype(np.float32)
    a = J.refine_varying_max(j(cc), j(sum_c), j(sum_ref), f0, 256.0)
    b = T.refine_varying_max(t(cc), t(sum_c), t(sum_ref), t(f0), 256.0)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)


@pytest.mark.parametrize("f32_u", [True, False])
def test_displacement_lse(rng, f32_u):
    sum_c, ssq_c, sum_ref, ssq_ref, prior = _sums(rng, normalized=f32_u)
    f0, _ = J.logpro_constants(j(sum_c), j(ssq_c), j(sum_ref), j(ssq_ref), j(prior),
                               256.0, images_normalized=f32_u)
    cc = rng.normal(0, 0.3, (2, 3, 5, 4, 4)).astype(np.float32)
    kw = dict(f32_u=f32_u)
    a = J.displacement_lse(j(cc), j(sum_c), j(sum_ref), f0, 256.0,
                           ssq_c=j(ssq_c), ssq_ref=j(ssq_ref), **kw)
    b = T.displacement_lse(t(cc), t(sum_c), t(sum_ref), t(f0), 256.0,
                           ssq_c=t(ssq_c), ssq_ref=t(ssq_ref), **kw)
    m_a, se_a, ds_a, cs_a = (np.asarray(x) for x in a)
    m_b, se_b, ds_b, cs_b = (x.numpy() for x in b)
    np.testing.assert_array_equal(ds_b, ds_a)
    np.testing.assert_array_equal(cs_b, cs_a)
    np.testing.assert_allclose(m_b, m_a, rtol=1e-6 if not f32_u else 1e-12)
    np.testing.assert_allclose(se_b, se_a, rtol=1e-6)
    assert m_b.dtype == m_a.dtype and ds_b.dtype == np.int32


def test_displacement_lse_exact_tie_first_occurrence(rng):
    """Exact ties resolve to the first flat index d·D+e (reference sweep
    order), on both sides."""
    sum_c, ssq_c, sum_ref, ssq_ref, prior = _sums(rng, o=1, c=1, i=2)
    f0, _ = J.logpro_constants(j(sum_c), j(ssq_c), j(sum_ref), j(ssq_ref), j(prior),
                               256.0, images_normalized=True)
    cc = np.zeros((1, 1, 2, 3, 3), np.float32)
    # sum_ref ≈ 0 ⇒ v = a·log1p(−N²cc²/F0) grows with |cc|: two equal maxima
    cc[0, 0, 0, 1, 2] = cc[0, 0, 0, 2, 0] = 0.5
    cc[0, 0, 1, 0, 1] = cc[0, 0, 1, 2, 2] = -0.5
    b = T.displacement_lse(t(cc), t(sum_c), t(sum_ref), t(f0), 256.0)
    a = J.displacement_lse(j(cc), j(sum_c), j(sum_ref), f0, 256.0)
    assert b[2].numpy().ravel().tolist() == [5, 1]
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))


@pytest.mark.parametrize("write_angles", [False, True])
def test_init_state(write_angles):
    a = J.init_state(4, 6, write_angles)
    b = T.init_state(4, 6, write_angles)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
            continue
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        assert y.numpy().dtype == np.asarray(x).dtype


def _merge_inputs(rng, o=2, c=3, i=4, d=5, masked=False):
    m = rng.normal(5, 1, (o, c, i)).astype(np.float32)
    se = rng.uniform(1, 3, (o, c, i)).astype(np.float32)
    ds = rng.integers(0, d * d, (o, c, i)).astype(np.int32)
    ccs = rng.normal(0, 1, (o, c, i)).astype(np.float32)
    k = rng.normal(-100, 3, (o, c, i))
    if masked:
        k[:] = -np.inf
    sum_c = rng.normal(5, 1, (o, c)).astype(np.float32)
    ssq_c = rng.uniform(50, 80, (o, c)).astype(np.float32)
    sum_ref = rng.normal(0, 1, i).astype(np.float32)
    disp = (np.arange(d) - d // 2).astype(np.int32)
    return m, se, ds, ccs, k, sum_c, ssq_c, sum_ref, disp


@pytest.mark.parametrize("write_angles", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_merge_block(rng, write_angles, masked):
    """Two blocks merged into a fresh state; the second is fully masked
    (k = −inf everywhere: the −inf−(−inf) NaN guard) when ``masked``."""
    o, n_orient = 2, 4
    sj = J.init_state(4, n_orient, write_angles)
    st = state_from_numpy({k: (np.asarray(v) if v is not None else None)
                           for k, v in sj._asdict().items()}, "cpu")
    for blk, msk in ((0, False), (1, masked)):
        args = _merge_inputs(rng, o=o, masked=msk)
        sj = J.merge_block(sj, *(j(x) for x in args), jnp.int32(blk * o), 256.0, 5)
        st = T.merge_block(st, *(t(x) for x in args), blk * o, 256.0, 5)
    got = state_to_numpy(st)
    for key, v in sj._asdict().items():
        if v is None:
            assert got[key] is None
            continue
        v = np.asarray(v)
        assert got[key].dtype == v.dtype, key
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], v, rtol=1e-12, err_msg=key)
    assert np.isfinite(got["total"]).all()


@pytest.mark.parametrize("write_angles", [False, True])
def test_merge_block_tensor_offset_is_bit_equal(rng, write_angles):
    """merge_block with the offset as a 0-d integer tensor (what a captured
    block step passes) gives the same bits as with an int, over three
    blocks of two orientations into a state padded to six, the last block
    half padding (its second orientation masked: k = −inf)."""
    o, n_orient_pad = 2, 6
    states = [T.init_state(4, n_orient_pad, write_angles) for _ in range(2)]
    for blk in range(3):
        args = [t(x) for x in _merge_inputs(rng, o=o)]
        if blk == 2:
            args[4][1] = -np.inf
        states[0] = T.merge_block(states[0], *args, blk * o, 256.0, 5)
        states[1] = T.merge_block(states[1], *args, torch.tensor(blk) * o, 256.0, 5)
    for key, a, b in zip(T.PosteriorState._fields, *states):
        assert (a is None) == (b is None) == (key.startswith("ang") and not write_angles), key
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), key
