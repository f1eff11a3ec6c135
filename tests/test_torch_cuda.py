"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: they skip where no NVIDIA card is present (the decision
is made inside a fixture, never at import). On a machine with a card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not have; this file needs only torch and the port.)

chip_smoke.py makes the same comparisons at the production shapes.
Tolerances: m, se rtol 1e-5 at these small shapes, the argmax exact away
from near-ties (two best lattice values within 1e-5·|a_coef|); cc and the
projection spectra < 5e-5 of their max magnitude.
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


def test_engine_kernel_branch_vs_plain_branch(rng, dev):
    """The engine on the card: kernel branch against plain branch, on a
    small problem with a stride-folded lattice, padding and per-angle
    slabs."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
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
    images = ImageStack(_normalize_stack(rng.normal(0, 1, (5, 16, 16)).astype(np.float32)))
    res = []
    for kern in (True, False):
        eng = BioEMEngine(p, build_orientations(p), model, images,
                          RunConfig(orient_block=3, use_kernels=kern), device=dev)
        assert eng.use_kernels == kern
        res.append(eng.results(eng.run()))
    np.testing.assert_allclose(res[0].log_prob, res[1].log_prob, rtol=0, atol=1e-4)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(res[0], f), getattr(res[1], f))
