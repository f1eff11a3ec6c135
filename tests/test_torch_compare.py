"""The comparison kernels' plain versions (ops/compare_cuda.py) against the
JAX Pallas kernels in interpret mode (ops/compare_pallas.py), on the same
numpy-seeded inputs.

K1 (fused comparison + displacement LSE): m and se to rtol 1e-5, the
argmax and the cc at the argmax exactly, except where the two best lattice
values lie within 1e-5·|a_coef| of each other (a different f32 summation
order may then swap them; the test counts such near-ties and requires
them rare). K3 (cc lattice only): rtol 2e-5 / atol 1e-4, the bound of
tests/test_pallas.py:test_fused_cc_matches_einsum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioem_tpu.core.posterior import displacement_dft_weights
from bioem_tpu.ops.compare_pallas import fused_compare_block as j_compare
from bioem_tpu.ops.compare_pallas import fused_displacement_cc as j_cc
from bioem_tpu_torch.ops import compare_cuda as C


def _inputs(rng, n_fold, n_disp, o=2, c=2, i=4):
    # N large enough that no two lattice displacements alias mod N
    n = 32 if n_disp * n_fold < 32 else 48
    f = n // 2 + 1
    disp = ((np.arange(n_disp) - n_disp // 2) * n_fold).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    m = n // n_fold
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    proj = (r(o, n, f), r(o, n, f))
    ctf = (r(c, n, f), r(c, n, f))
    img = (r(i, n, f), r(i, n, f))
    w = (np.ascontiguousarray(wx.real[:, :m]), np.ascontiguousarray(wx.imag[:, :m]),
         wy.real.copy(), wy.imag.copy())
    # u = a_u·cc − b_u·cc² stays well above −1 at these cc magnitudes
    a_u = np.abs(rng.normal(0, 1e-5, (o * c, i))).astype(np.float32)
    b_u = np.abs(rng.normal(0, 1e-8, (o * c, i))).astype(np.float32)
    return proj, ctf, img, w, a_u, b_u


@pytest.mark.parametrize("n_fold", [1, 2])
@pytest.mark.parametrize("n_disp", [5, 21])
def test_fused_compare_plain_vs_pallas(rng, n_fold, n_disp):
    proj, ctf, img, w, a_u, b_u = _inputs(rng, n_fold, n_disp)
    a_coef = -511.5  # (3 − N²)/2 at N = 32
    args = (*proj, *ctf, *img, *w, a_u, b_u)
    ref = j_compare(*(jnp.asarray(x) for x in args), a_coef=a_coef, img_tile=2,
                    n_fold=n_fold, interpret=True, mxu_mode="highest")
    got = C.fused_compare_block(*(torch.as_tensor(x) for x in args),
                                a_coef=a_coef, n_fold=n_fold)
    assert C.fused_compare_block.launches == 0  # CPU tensors: plain version
    (rm, rs, rd, rc), (gm, gs, gd, gc) = (
        [np.asarray(x) for x in ref], [x.numpy() for x in got])
    assert gd.dtype == np.int32 and gm.shape == rm.shape == (4, 4)
    np.testing.assert_allclose(gm, rm, rtol=1e-5)
    np.testing.assert_allclose(gs, rs, rtol=1e-5)
    # near-ties of the plain version's two best lattice values
    cc = C.displacement_cc_plain(
        *(torch.as_tensor(x) for x in (
            (proj[0][:, None] * ctf[0][None] + proj[1][:, None] * ctf[1][None]).reshape(4, *proj[0].shape[1:]),
            (proj[1][:, None] * ctf[0][None] - proj[0][:, None] * ctf[1][None]).reshape(4, *proj[0].shape[1:]),
            *img, *w)), n_fold=n_fold).flatten(2)
    v = a_coef * torch.log1p(torch.as_tensor(a_u)[..., None] * cc
                             - torch.as_tensor(b_u)[..., None] * cc * cc)
    top2 = torch.topk(v, 2, dim=-1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 1e-5 * abs(a_coef)).numpy()
    assert tie.sum() <= 2
    np.testing.assert_array_equal(gd[~tie], rd[~tie])
    np.testing.assert_allclose(gc[~tie], rc[~tie], rtol=1e-5)


@pytest.mark.parametrize("n_fold", [1, 2])
@pytest.mark.parametrize("n_disp", [5, 21])
def test_fused_cc_plain_vs_pallas(rng, n_fold, n_disp):
    proj, _ctf, img, w, _au, _bu = _inputs(rng, n_fold, n_disp, o=3)
    args = (*proj, *img, *w)
    ref = np.asarray(j_cc(*(jnp.asarray(x) for x in args), img_tile=2, n_fold=n_fold,
                          interpret=True, mxu_mode="highest"))
    got = C.fused_displacement_cc(*(torch.as_tensor(x) for x in args), n_fold=n_fold)
    assert C.fused_displacement_cc.launches == 0
    assert tuple(got.shape) == ref.shape == (3, 4, n_disp, n_disp)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-4)


def test_fused_cc_plain_vs_f64(rng):
    """cc to < 5e-5 of max|cc| against an f64 NumPy lattice (the bound of
    tests/test_pallas.py:test_fused_cc_stacked_accuracy), folded rows."""
    proj, _ctf, img, w, _au, _bu = _inputs(rng, 2, 21, o=2)
    got = C.fused_displacement_cc(*(torch.as_tensor(x) for x in (*proj, *img, *w)),
                                  n_fold=2).numpy()
    conv = proj[0].astype(np.float64) + 1j * proj[1]
    im = img[0].astype(np.float64) + 1j * img[1]
    p = conv[:, None] * im[None]
    pf = p.reshape(*p.shape[:2], 2, p.shape[2] // 2, p.shape[-1]).sum(axis=2)
    ref = np.matmul(np.matmul(w[0] + 1j * w[1].astype(np.float64), pf),
                    (w[2] + 1j * w[3].astype(np.float64)).T).real
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-5


@pytest.mark.parametrize("fn", ["fused_compare_block", "fused_displacement_cc"])
def test_wrappers_reject_other_devices(fn):
    """Only CPU tensors take the plain version; a 'meta' tensor is neither
    CPU nor CUDA and must raise, never fall back."""
    x = torch.empty((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "fused_compare_block":
            C.fused_compare_block(*([x] * 12), a_coef=-1.0)
        else:
            C.fused_displacement_cc(*([x] * 8))
