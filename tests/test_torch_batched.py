"""The image-batched comparison (K4) and the engine's comparison paths
against bioem_tpu on the same numpy-seeded inputs.

K4's wrapper on CPU tensors runs its plain version (the one K1 shares),
held against the JAX K4 (``fused_compare_block(..., batched_stage1=True)``)
in interpret mode. That JAX kernel is 3-pass bf16, ~5e-6 relative cc
(compare_pallas.py:36-39), so m and se are held to rtol 5e-5; the argmax
and the cc at the argmax must agree away from near-ties (the two best
lattice values within 1e-5·|a_coef|), as in test_torch_compare.py.

The engines: the port's kernel branch with K4 (``fused_batched``) and with
the hybrid (``fused_lse=False``: K3 + the torch displacement LSE) against
the JAX engine's same configuration, as tests/test_pallas.py runs it:
logP atol 1e-4, the argmax tuple exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioem_tpu.config import RunConfig as JConfig
from bioem_tpu.core.engine import BioEMEngine as JEngine
from bioem_tpu.core.orientations import build_orientations as j_orients
from bioem_tpu.ops.compare_pallas import fused_compare_block as j_compare
from bioem_tpu_torch.config import RunConfig as TConfig
from bioem_tpu_torch.core.engine import BioEMEngine as TEngine
from bioem_tpu_torch.core.orientations import build_orientations as t_orients
from bioem_tpu_torch.ops import compare_cuda as C

from .conftest import tiny_images, tiny_model, tiny_params
from .test_torch_compare import _inputs

ARGMAX = ("best_orient", "best_conv", "best_cent_x", "best_cent_y")


@pytest.mark.parametrize("n_fold,n_disp", [(1, 5), (2, 21)])
def test_batched_plain_vs_jax_batched(rng, n_fold, n_disp):
    proj, ctf, img, w, a_u, b_u = _inputs(rng, n_fold, n_disp)
    a_coef = -511.5  # (3 − N²)/2 at N = 32
    args = (*proj, *ctf, *img, *w, a_u, b_u)
    ref = j_compare(*(jnp.asarray(x) for x in args), a_coef=a_coef, img_tile=2,
                    n_fold=n_fold, interpret=True, batched_stage1=True)
    got = C.fused_compare_block_batched(*(torch.as_tensor(x) for x in args),
                                        a_coef=a_coef, n_fold=n_fold, img_tile=2)
    assert C.fused_compare_block_batched.launches == 0  # CPU tensors: plain version
    (rm, rs, rd, rc), (gm, gs, gd, gc) = (
        [np.asarray(x) for x in ref], [x.numpy() for x in got])
    assert gd.dtype == np.int32 and gm.shape == rm.shape == (4, 4)
    np.testing.assert_allclose(gm, rm, rtol=5e-5)
    np.testing.assert_allclose(gs, rs, rtol=5e-5)
    n = proj[0].shape[1]
    conv_re = (proj[0][:, None] * ctf[0][None] + proj[1][:, None] * ctf[1][None]).reshape(4, n, -1)
    conv_im = (proj[1][:, None] * ctf[0][None] - proj[0][:, None] * ctf[1][None]).reshape(4, n, -1)
    cc = C.displacement_cc_plain(*(torch.as_tensor(x) for x in (conv_re, conv_im, *img, *w)),
                                 n_fold=n_fold).flatten(2)
    v = a_coef * torch.log1p(torch.as_tensor(a_u)[..., None] * cc
                             - torch.as_tensor(b_u)[..., None] * cc * cc)
    top2 = torch.topk(v, 2, dim=-1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 1e-5 * abs(a_coef)).numpy()
    assert tie.sum() <= 2
    np.testing.assert_array_equal(gd[~tie], rd[~tie])
    np.testing.assert_allclose(gc[~tie], rc[~tie], rtol=1e-5)


def test_batched_rejects_ragged_tile(rng):
    """The image count must be a multiple of the tile, as the JAX kernel
    requires (compare_pallas.py:509-511) — on every device."""
    proj, ctf, img, w, a_u, b_u = _inputs(rng, 1, 5)
    args = [torch.as_tensor(x) for x in (*proj, *ctf, *img, *w, a_u, b_u)]
    with pytest.raises(ValueError, match="not a multiple of tile 3"):
        C.fused_compare_block_batched(*args, a_coef=-1.0, img_tile=3)
    x = torch.empty((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        C.fused_compare_block_batched(*([x] * 12), a_coef=-1.0, img_tile=1)


def _problem(rng, n_img=4, **pkw):
    p = tiny_params(**pkw)
    return p, tiny_model(rng), tiny_images(rng, n_img, p.n_pixels)


@pytest.mark.parametrize("fused_lse,fused_batched", [(True, True), (False, False)],
                         ids=["k4", "hybrid"])
def test_engine_comparison_paths_match_jax(rng, fused_lse, fused_batched):
    p, model, images = _problem(rng)
    ej = JEngine(p, j_orients(p), model, images, JConfig(
        orient_block=2, use_pallas=True, pallas_img_tile=2, fused_lse=fused_lse,
        fused_batched=fused_batched, pallas_projection=False))
    et = TEngine(p, t_orients(p), model, images, TConfig(
        orient_block=2, use_kernels=True, kernel_img_tile=2, fused_lse=fused_lse,
        fused_batched=fused_batched, kernel_projection=False), device="cpu")
    assert (et.fused_lse, et.fused_batched, et.i_block) == (fused_lse, fused_batched, 2)
    assert (et.n_img_pad, et.n_orient_pad) == (ej.n_img_pad, ej.n_orient_pad)
    rj, rt = ej.results(ej.run()), et.results(et.run())
    np.testing.assert_allclose(rt.log_prob, rj.log_prob, rtol=0, atol=1e-4)
    for f in ARGMAX:
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), err_msg=f)


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
def test_engine_k4_keeps_its_tile(rng, forced):
    """K4's tile is only the image padding granularity and the contract
    I % tile = 0 (the kernel's work and shared memory do not depend on it,
    csrc/compare_batched.cu): the engine keeps any tile as given, forced or
    not, and pads the images to it; K1 keeps it as its padding
    granularity."""
    p, model, images = _problem(rng, n_img=20)
    kw = dict(use_kernels=True, fused_batched=True, kernel_img_tile=12)
    if forced:
        kw["forced"] = frozenset({"kernel_img_tile", "fused_batched"})
    eng = TEngine(p, t_orients(p), model, images, TConfig(**kw), device="cpu")
    assert eng.fused_batched and eng.i_block == 12 and eng.n_img_pad == 24
    eng1 = TEngine(p, t_orients(p), model, images,
                   TConfig(use_kernels=True, kernel_img_tile=20), device="cpu")
    assert not eng1.fused_batched and eng1.i_block == 20 and eng1.n_img_pad == 20


def test_engine_batched_needs_fused_normalised_images(rng):
    """DC-dominated (NO_MAP_NORM) images take the hybrid whatever
    fused_batched says, as in the JAX engine."""
    p, model, images = _problem(rng, no_map_norm=True)
    images.maps[:] += np.float32(3.0)
    eng = TEngine(p, t_orients(p), model, images,
                  TConfig(use_kernels=True, fused_batched=True, kernel_img_tile=2),
                  device="cpu")
    assert not eng._f32_corr_ok and not eng.fused_batched


def test_kernel_projection_switch(rng, monkeypatch):
    """kernel_projection=False takes the plain projection on the kernel
    branch; None follows use_kernels."""
    from bioem_tpu_torch.core import engine as eng_mod

    p, model, images = _problem(rng)
    calls = []
    real = eng_mod.project_fourier_batch_kernel
    monkeypatch.setattr(eng_mod, "project_fourier_batch_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for kp, want in ((None, True), (False, False)):
        calls.clear()
        eng = TEngine(p, t_orients(p), model, images,
                      TConfig(use_kernels=True, kernel_projection=kp), device="cpu")
        assert eng.kernel_projection == want
        eng.run()
        assert bool(calls) == want
