"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip where no NVIDIA card is present (the decision
is made inside a fixture, never at import). On a machine with a card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not have; this file needs only torch and the port.)

chip_smoke.py makes the same comparisons at the production shapes.
Tolerances: m, se rtol 1e-5 at these small shapes, the argmax exact away
from near-ties (two best lattice values within 1e-5·|a_coef|); cc and the
projection spectra < 5e-5 of their max magnitude. The image-batched
kernel (K4, 3xTF32 tensor cores) is held to K1's tolerances.
"""

import numpy as np
import pytest
import torch

from bioem_tpu_torch.core.posterior import displacement_dft_weights
from bioem_tpu_torch.ops import compare_cuda as C
from bioem_tpu_torch.ops import project_cuda as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


def _cmp_inputs(rng, dev, n=32, n_fold=2, n_disp=9, o=2, c=3, i=5):
    f = n // 2 + 1
    disp = ((np.arange(n_disp) - n_disp // 2) * n_fold).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    m = n // n_fold
    g = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    r = lambda *s: g(rng.normal(0, 1, s))  # noqa: E731
    return (r(o, n, f), r(o, n, f), r(c, n, f), r(c, n, f), r(i, n, f), r(i, n, f),
            g(wx.real[:, :m]), g(wx.imag[:, :m]), g(wy.real), g(wy.imag),
            g(np.abs(rng.normal(0, 1e-5, (o * c, i)))), g(np.abs(rng.normal(0, 1e-8, (o * c, i)))))


@pytest.mark.parametrize("n_fold,n_disp", [(1, 5), (2, 9), (2, 21), (1, 30)])
def test_fused_compare_kernel_vs_plain(rng, dev, n_fold, n_disp):
    n = 48 if n_disp * n_fold >= 32 else 32
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp)
    before = C.fused_compare_block.launches
    km, ks, kd, kc = C.fused_compare_block(*args, a_coef=-511.5, n_fold=n_fold)
    torch.cuda.synchronize()
    assert C.fused_compare_block.launches == before + 1
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=-511.5, n_fold=n_fold)
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=0)
    assert kd.dtype == torch.int32
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_fold,n_disp", [(1, 5), (2, 21)])
def test_fused_cc_kernel_vs_plain(rng, dev, n_fold, n_disp):
    n = 48 if n_disp * n_fold >= 32 else 32
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=6)
    conv = (args[0], args[1])
    k = C.fused_displacement_cc(*conv, *args[4:10], n_fold=n_fold)
    p = C.displacement_cc_plain(*conv, *args[4:10], n_fold=n_fold)
    torch.cuda.synchronize()
    assert float((k - p).abs().max()) < 5e-5 * float(p.abs().max())


@pytest.mark.parametrize("n", [15, 64])
def test_projection_kernel_vs_plain(rng, dev, n):
    f = n // 2 + 1
    gi = lambda *s: torch.as_tensor(rng.integers(-2 * n, 3 * n, s).astype(np.int32), device=dev)  # noqa: E731
    r = lambda *s: torch.as_tensor(rng.normal(0, 1, s).astype(np.float32), device=dev)  # noqa: E731
    args = (gi(3, 4, 40), gi(3, 4, 40), r(3, 4, 40).abs(), r(3, n, f), r(3, n, f))
    kr, ki = P.fourier_project_block(*args, n=n)
    pr, pi = P.fourier_project_block_plain(*args, n=n)
    torch.cuda.synchronize()
    scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
    assert float((kr - pr).abs().max()) < 5e-5 * scale
    assert float((ki - pi).abs().max()) < 5e-5 * scale


def test_wrapper_rejects_bad_input(rng, dev):
    args = list(_cmp_inputs(rng, dev))
    args[4] = args[4].double()
    with pytest.raises(ValueError, match="float32"):
        C.fused_compare_block(*args, a_coef=-1.0, n_fold=2)
    args = list(_cmp_inputs(rng, dev))
    args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        C.fused_compare_block(*args, a_coef=-1.0, n_fold=2)


@pytest.mark.parametrize("it", [1, 2, 4])
@pytest.mark.parametrize("n_fold,n_disp", [(1, 5), (2, 21)])
def test_batched_kernel_vs_plain(rng, dev, n_fold, n_disp, it):
    n = 48 if n_disp * n_fold >= 32 else 32
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, i=8)
    before = C.fused_compare_block_batched.launches
    km, ks, kd, kc = C.fused_compare_block_batched(*args, a_coef=-511.5, n_fold=n_fold,
                                                   img_tile=it)
    torch.cuda.synchronize()
    assert C.fused_compare_block_batched.launches == before + 1
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=-511.5, n_fold=n_fold)
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=0)
    assert kd.dtype == torch.int32
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)


def test_batched_wrapper_rejects_bad_tiles(rng, dev):
    """I % IT != 0 and a tile whose operands exceed the shared memory of a
    block raise before any launch. The library sizes the production tiles
    within a block's shared memory and has no instance past tile 16 or
    past four t1 row tiles per warp."""
    for d, m, it, fits in [(21, 112, 8, True), (21, 112, 16, True), (5, 15, 5, True),
                           (21, 112, 17, False), (61, 112, 16, False), (61, 112, 4, True),
                           (21, 448, 16, False)]:
        assert C.batched_tile_fits(d, m, 113, it) == fits, (d, m, it)
    assert C.batched_smem_bytes(21, 112, 113, 17) == 0
    args = _cmp_inputs(rng, dev, n=32, n_fold=2, n_disp=9, i=6)
    before = C.fused_compare_block_batched.launches
    with pytest.raises(ValueError, match="not a multiple of tile 4"):
        C.fused_compare_block_batched(*args, a_coef=-1.0, n_fold=2, img_tile=4)
    args = _cmp_inputs(rng, dev, n=448, n_fold=1, n_disp=21, o=1, c=1, i=16)
    with pytest.raises(ValueError, match="shared memory"):
        C.fused_compare_block_batched(*args, a_coef=-1.0, n_fold=1, img_tile=16)
    assert C.fused_compare_block_batched.launches == before


def _engine_problem(rng, n_img=5):
    """A small problem with a stride-folded lattice and per-angle slabs."""
    from bioem_tpu_torch.core.orientations import build_orientations
    from bioem_tpu_torch.io.map_io import ImageStack, _normalize_stack
    from bioem_tpu_torch.io.model_io import Model
    from bioem_tpu_torch.params import BioEMParams

    p = BioEMParams(
        pixel_size=1.5, n_pixels=16, n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=2, start_defocus=0.5, end_defocus=1.5, n_env=2,
        start_bfactor=1.0, end_bfactor=100.0, max_displace_center=4,
        grid_space_center=2, grid_points_alpha=2, grid_points_beta=2,
        write_angles=3,
    ).finalize_ctf_mode()
    dens = rng.uniform(40.0, 100.0, 12).astype(np.float32)
    model = Model(rng.uniform(-6, 6, (12, 3)).astype(np.float32),
                  rng.uniform(1.0, 3.2, 12).astype(np.float32), dens, float(dens.sum()))
    images = ImageStack(_normalize_stack(rng.normal(0, 1, (n_img, 16, 16)).astype(np.float32)))
    return p, build_orientations(p), model, images


def test_engine_kernel_branch_vs_plain_branch(rng, dev):
    """The engine on the card: kernel branch against plain branch, with
    image padding."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    problem = _engine_problem(rng)
    res = {}
    for name, kw in (("plain", dict(use_kernels=False)), ("k1", dict(use_kernels=True)),
                     ("k4", dict(use_kernels=True, fused_batched=True, kernel_img_tile=5)),
                     ("hybrid", dict(use_kernels=True, fused_lse=False))):
        before = C.fused_compare_block_batched.launches
        eng = BioEMEngine(*problem, RunConfig(orient_block=3, **kw), device=dev)
        assert eng.use_kernels == kw["use_kernels"]
        res[name] = eng.results(eng.run())
        assert (C.fused_compare_block_batched.launches > before) == (name == "k4")
    for name in ("k1", "k4", "hybrid"):
        np.testing.assert_allclose(res[name].log_prob, res["plain"].log_prob, rtol=0, atol=1e-4)
        for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
            np.testing.assert_array_equal(getattr(res[name], f), getattr(res["plain"], f))


def test_engine_k4_tile_on_the_card(rng, dev):
    """On the card the kernel library sizes K4's tile: a forced tile it has
    no instance for raises at construction, the unforced default is clamped
    down to the largest tile that fits (16 here)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    problem = _engine_problem(rng, n_img=20)
    kw = dict(use_kernels=True, fused_batched=True, kernel_img_tile=20)
    with pytest.raises(ValueError, match="forced"):
        BioEMEngine(*problem, RunConfig(**kw, forced=frozenset({"kernel_img_tile"})), device=dev)
    eng = BioEMEngine(*problem, RunConfig(**kw), device=dev)
    assert eng.fused_batched and eng.i_block == 16 and eng.n_img_pad == 32
