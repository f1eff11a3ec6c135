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
kernel (K4) is held to K1's tolerances at every width it has (D ≤ 32),
every fold count and several tiles; K1 at lattice widths up to D = 61,
folds 1–4, odd N, M = 224 and image counts that end a run of four
mid-way; both to the same bits across two launches. The projection (K2)
also with per-group point counts that skip padding, at its largest N and
to the same bits across two launches. K3 (K1's kernel writing the
lattice) at D = 5…61 and folds 1–4, at N = 15 and at D = 61, M = 224,
to the same bits across two launches. The engine's replayed pass
(a captured block step) bit-equal to its eager loop for K1, K4 and the
hybrid, through a checkpoint resume too, with launch counters that count
each replay; on swapped banks too (a streamed image chunk, a ranked model
with more points per radius group, whose counts K2 reads), with one
capture per engine under run_streaming and rank_models; a 2×2 mesh of
four slots on one card (one capture each) equal to the single engine on
each branch, streamed and ranked. The probes: P1's FMA, 3xTF32 and FP64
schemes at a median relative error below 1e-6 from f64 (the TPU probe's
"multi-pass" line), 1xTF32 within its rounding bound, every scheme at
ragged shapes with its copies equal;
P2's two structures within the f32 summation bound the probe tool states
(``kernel_probe.p2_updates``); P3's full body bit-equal to K1 and K4. The
tools: the error budget of every engine configuration against the all-f64
oracle within the JAX suite's limits, and scale_bench at a small size.
"""

import numpy as np
import pytest
import torch

from bioem_tpu_torch.core.posterior import displacement_dft_weights
from bioem_tpu_torch.ops import compare_cuda as C
from bioem_tpu_torch.ops import probe_cuda as PR
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
    every = torch.full((3,), 40, dtype=torch.int32, device=dev)
    kr, ki = P.fourier_project_block(*args, n=n, counts=every)
    pr, pi = P.fourier_project_block_plain(*args, n=n)
    torch.cuda.synchronize()
    scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
    assert float((kr - pr).abs().max()) < 5e-5 * scale
    assert float((ki - pi).abs().max()) < 5e-5 * scale


# K1 (wgmma, conv formed once per orientation·ctf) at the lattice widths
# and folds its reach covers: D = 5…61 (one and two N chunks), folds 1–4,
# odd N, a stride-1 lattice at N = 224 (M = 224), image counts that end a
# run of four mid-way.
K1_SHAPES = [  # (n_disp, n_fold, n, images)
    (5, 1, 15, 5), (5, 2, 32, 1), (9, 1, 32, 64), (9, 3, 48, 5), (9, 4, 64, 5),
    (21, 2, 48, 201), (21, 1, 224, 5), (30, 1, 64, 5), (35, 1, 48, 5), (35, 2, 80, 7),
    (61, 1, 64, 3)]


@pytest.mark.parametrize("n_disp,n_fold,n,n_img", K1_SHAPES)
def test_k1_widths_folds_and_image_counts(rng, dev, n_disp, n_fold, n, n_img):
    """K1 against its plain version at every shape above (m, se rtol 1e-5,
    the argmax exact on ≥ 90 % of the comparisons, cc there rtol 1e-5)."""
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=2, c=2, i=n_img)
    a_coef = -0.5 * n * n
    before = C.fused_compare_block.launches
    km, ks, kd, kc = C.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)
    torch.cuda.synchronize()
    assert C.fused_compare_block.launches == before + 1
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
    # se carries v's absolute f32 error, |a_coef|·δcc: at N = 224 (a_coef
    # −25088) chip_smoke's production limit, 1.5e-4, applies.
    torch.testing.assert_close(ks, ps, rtol=1e-5 if n <= 80 else 1.5e-4, atol=0)
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)


def test_k1_is_deterministic(rng, dev):
    """Two K1 launches on the same inputs give the same bits (no atomics)."""
    args = _cmp_inputs(rng, dev, n=64, n_fold=2, n_disp=21, o=3, c=4, i=30)
    runs = [C.fused_compare_block(*args, a_coef=-2047.5, n_fold=2) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_k1_plan_matches_the_library(dev):
    """The wrapper's tiling rule (compare_cuda.k1_smem_bytes) gives the
    kernel library's shared memory (the C formula K1 and K3 both launch
    with)."""
    from bioem_tpu_torch.ops import _build

    lib = _build.load()
    for d, m, f, n_fold in [(21, 112, 113, 2), (5, 15, 8, 1), (35, 48, 41, 1), (61, 64, 33, 1),
                            (21, 224, 113, 1), (9, 12, 25, 4), (61, 224, 113, 1)]:
        for n_wg in (2, 4):
            for kc in (1, 2, 4, 8):
                assert (lib.bioem_fused_compare_smem_bytes(d, m, f, n_fold, n_wg, kc)
                        == C.k1_smem_bytes(d, m, f, n_fold, n_wg, kc)), (d, m, n_wg, kc)


@pytest.mark.parametrize("n", [15, 64, 224])
def test_projection_kernel_counts_and_padding(rng, dev, n):
    """K2 with per-group point counts against its plain version: a group
    whose points are all masked, a group of one point, negative snapped
    positions and Pp = 13, not a multiple of 8 (the slots past a group's
    count hold garbage densities the kernel must not read)."""
    f, g, o, pp = n // 2 + 1, 4, 3, 13
    counts = torch.tensor([13, 0, 1, 7], dtype=torch.int32, device=dev)
    i0 = torch.as_tensor(rng.integers(-2 * n, n, (g, o, pp)).astype(np.int32), device=dev)
    j0 = torch.as_tensor(rng.integers(-2 * n, n, (g, o, pp)).astype(np.int32), device=dev)
    dens = rng.uniform(0.5, 2.0, (g, o, pp)).astype(np.float32)
    dens[0, :, ::3] = 0.0  # out of bounds for some orientations
    dens[1] = 0.0  # every point masked
    st = [torch.as_tensor(rng.normal(0, 1, (g, n, f)).astype(np.float32), device=dev)
          for _ in range(2)]
    args = (i0, j0, torch.as_tensor(dens, device=dev), *st)
    before = P.fourier_project_block.launches
    kr, ki = P.fourier_project_block(*args, n=n, counts=counts)
    assert P.fourier_project_block.launches == before + 1
    pr, pi = P.fourier_project_block_plain(*args, n=n, counts=counts)
    torch.cuda.synchronize()
    scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
    assert float((kr - pr).abs().max()) < 5e-5 * scale
    assert float((ki - pi).abs().max()) < 5e-5 * scale


def test_projection_kernel_reach_and_bits(rng, dev):
    """K2's reach (project_cuda.MAX_N) is the library's, N = MAX_N runs and
    one past it raises; two launches on the production-shaped inputs give
    the same bits (a fixed order of adds, no atomics)."""
    from bioem_tpu_torch.ops import _build
    from bioem_tpu_torch.tools.kernel_probe import production_projection_inputs

    assert _build.load().bioem_fourier_project_max_n() == P.MAX_N
    i0, j0, dens, st_re, st_im, counts = production_projection_inputs(dev)
    runs = [P.fourier_project_block(i0, j0, dens, st_re, st_im, n=224, counts=counts)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for n, ok in ((P.MAX_N, True), (P.MAX_N + 1, False)):
        f = n // 2 + 1
        ij = torch.as_tensor(rng.integers(-n, n, (1, 1, 8)).astype(np.int32), device=dev)
        st = torch.ones((1, n, f), device=dev)
        args = (ij, ij.flip(-1).contiguous(), torch.ones((1, 1, 8), device=dev), st, st)
        one = torch.tensor([8], dtype=torch.int32, device=dev)
        if ok:
            kr, ki = P.fourier_project_block(*args, n=n, counts=one)
            pr, pi = P.fourier_project_block_plain(*args, n=n)
            torch.cuda.synchronize()
            scale = float(torch.maximum(pr.abs().max(), pi.abs().max()))
            assert float(torch.maximum((kr - pr).abs().max(), (ki - pi).abs().max())) < 5e-5 * scale
        else:
            with pytest.raises(ValueError, match="too large"):
                P.fourier_project_block(*args, n=n, counts=one)


def test_probe_projection_points(dev):
    """The probe tool's K2 point scaling: reading every slot (the padding
    holds zero density) gives the model's spectrum to 5e-5 of its max."""
    from bioem_tpu_torch.tools.kernel_probe import probe_projection_points

    out = probe_projection_points(say=lambda s: None)
    assert out["points"] == {"none": 0, "model": 500, "every slot": 1120}
    assert out["max_rel_diff"] < 5e-5
    assert all(t > 0 for t in out["ms"].values())


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
    """I % IT != 0, a lattice wider than the instances (D > 32) and a shape
    whose operands exceed the shared memory of a block raise before any
    launch. The library has instances for D ≤ 32 (wgmma n16..n64) at any
    tile, with W split hi/lo at 2·Dp × 2·M resident: it fits at M = 112
    and not at M = 224 (D = 21) or 448."""
    for d, m, fits in [(21, 112, True), (5, 15, True), (30, 112, True), (32, 112, True),
                       (5, 224, True), (33, 112, False), (61, 112, False), (21, 224, False),
                       (21, 448, False)]:
        assert C.batched_fits(d, m, 113) == fits, (d, m)
    assert C.batched_smem_bytes(33, 112, 113) == 0
    args = _cmp_inputs(rng, dev, n=32, n_fold=2, n_disp=9, i=6)
    before = C.fused_compare_block_batched.launches
    with pytest.raises(ValueError, match="not a multiple of tile 4"):
        C.fused_compare_block_batched(*args, a_coef=-1.0, n_fold=2, img_tile=4)
    args = _cmp_inputs(rng, dev, n=80, n_fold=1, n_disp=33, o=1, c=1, i=4)
    with pytest.raises(ValueError, match="no kernel instance for D=33"):
        C.fused_compare_block_batched(*args, a_coef=-1.0, n_fold=1, img_tile=4)
    args = _cmp_inputs(rng, dev, n=448, n_fold=1, n_disp=21, o=1, c=1, i=16)
    with pytest.raises(ValueError, match="shared memory"):
        C.fused_compare_block_batched(*args, a_coef=-1.0, n_fold=1, img_tile=16)
    assert C.fused_compare_block_batched.launches == before


# K4's widths (2·Dp = 16, 32, 48, 64) at folds 1 and 2, with an odd N, and
# lattice strides 3 and 4 (the folds past the second are formed outside
# the conv buffer the warpgroup shares): every tile below divides the 80
# images.
K4_SHAPES = [(5, 1, 15), (5, 2, 32), (9, 1, 32), (9, 2, 32), (21, 1, 48), (21, 2, 48),
             (30, 1, 64), (30, 2, 64), (9, 3, 48), (9, 4, 64)]


@pytest.mark.parametrize("it", [1, 5, 8, 16])
@pytest.mark.parametrize("n_disp,n_fold,n", K4_SHAPES)
def test_batched_kernel_widths_and_tiles(rng, dev, n_disp, n_fold, n, it):
    """K4 against its plain version at every wgmma width it has, fold
    counts 1 to 4 and the tiles 1, 5, 8 and 16 (ragged frequency tiles:
    F = 8, 17, 25, 33)."""
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=2, c=3, i=80)
    a_coef = -0.5 * n * n
    km, ks, kd, kc = C.fused_compare_block_batched(*args, a_coef=a_coef, n_fold=n_fold,
                                                   img_tile=it)
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    torch.cuda.synchronize()
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=0)
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("it", [8, 16])
def test_batched_kernel_is_deterministic(rng, dev, it):
    """Two K4 launches on the same inputs give the same bits (no atomics)."""
    args = _cmp_inputs(rng, dev, n=64, n_fold=2, n_disp=21, o=3, c=4, i=32)
    runs = [C.fused_compare_block_batched(*args, a_coef=-2047.5, n_fold=2, img_tile=it)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _engine_problem(rng, n_img=5, n_pix=16, max_disp=4, stride=2):
    """A small problem with a stride-folded lattice and per-angle slabs."""
    from bioem_tpu_torch.core.orientations import build_orientations
    from bioem_tpu_torch.io.map_io import ImageStack, _normalize_stack
    from bioem_tpu_torch.io.model_io import Model
    from bioem_tpu_torch.params import BioEMParams

    p = BioEMParams(
        pixel_size=1.5, n_pixels=n_pix, n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=2, start_defocus=0.5, end_defocus=1.5, n_env=2,
        start_bfactor=1.0, end_bfactor=100.0, max_displace_center=max_disp,
        grid_space_center=stride, grid_points_alpha=2, grid_points_beta=2,
        write_angles=3,
    ).finalize_ctf_mode()
    dens = rng.uniform(40.0, 100.0, 12).astype(np.float32)
    model = Model(rng.uniform(-6, 6, (12, 3)).astype(np.float32),
                  rng.uniform(1.0, 3.2, 12).astype(np.float32), dens, float(dens.sum()))
    images = ImageStack(_normalize_stack(
        rng.normal(0, 1, (n_img, n_pix, n_pix)).astype(np.float32)))
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
    """On the card the engine keeps K4's tile as given (20 here, forced or
    not: the kernel's work does not depend on it) and runs K4; on a lattice
    K4 has no instance for (D = 35 > 32) it runs K1, even with K4 forced,
    and agrees with the plain branch."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    problem = _engine_problem(rng, n_img=20)
    kw = dict(use_kernels=True, fused_batched=True, kernel_img_tile=20)
    for forced in (frozenset(), frozenset({"kernel_img_tile", "fused_batched"})):
        eng = BioEMEngine(*problem, RunConfig(**kw, forced=forced), device=dev)
        assert eng.fused_batched and eng.i_block == 20 and eng.n_img_pad == 20
    wide = _engine_problem(rng, n_img=4, n_pix=48, max_disp=17, stride=1)
    res = {}
    for name, cfg in (("plain", RunConfig(use_kernels=False)),
                      ("k4", RunConfig(**kw, forced=frozenset({"fused_batched"})))):
        eng = BioEMEngine(*wide, cfg, device=dev)
        before = (C.fused_compare_block.launches, C.fused_compare_block_batched.launches)
        res[name] = eng.results(eng.run())
    assert eng.disp.shape[0] == 35 and not eng.fused_batched
    assert C.fused_compare_block.launches > before[0]
    assert C.fused_compare_block_batched.launches == before[1]
    np.testing.assert_allclose(res["k4"].log_prob, res["plain"].log_prob, rtol=0, atol=1e-4)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(res["k4"], f), getattr(res["plain"], f))


def test_engine_k1_pass_on_a_wide_lattice(rng, dev):
    """The engine's default kernel pass on a stride-1 D = 35 lattice (K4
    has no instance above D = 32, so the pass runs K1) against the plain
    branch: logP within 1e-4, argmax tuples equal."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    wide = _engine_problem(rng, n_img=6, n_pix=48, max_disp=17, stride=1)
    res = {}
    for name, cfg in (("plain", RunConfig(use_kernels=False)),
                      ("k1", RunConfig(use_kernels=True, autotune=False))):
        eng = BioEMEngine(*wide, cfg, device=dev)
        before = C.fused_compare_block.launches
        res[name] = eng.results(eng.run())
    assert eng.disp.shape[0] == 35 and not eng.fused_batched
    assert C.fused_compare_block.launches > before
    np.testing.assert_allclose(res["k1"].log_prob, res["plain"].log_prob, rtol=0, atol=1e-4)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(res["k1"], f), getattr(res["plain"], f))


@pytest.mark.parametrize("scheme", ["fma", "3xtf32", "f64tc"])
def test_probe_f32_product_schemes(rng, dev, scheme):
    """P1 at the TPU probe's shape: the f32-accurate schemes against f64,
    at a second batch copy too; 1xTF32 is not f32-accurate."""
    a = rng.normal(0, 1, (96, 112)).astype(np.float32)
    b = rng.normal(0, 1, (112, 113)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    before = PR.f32_product.launches
    out = PR.f32_product(ta, tb, scheme=scheme, batch=2)
    one = PR.f32_product(ta, tb, scheme="tf32")[0].cpu().numpy()
    torch.cuda.synchronize()
    assert PR.f32_product.launches == before + 2
    rel = lambda x: np.abs(x - ref) / np.maximum(np.abs(ref), 1e-30)  # noqa: E731
    assert np.median(rel(out[0].cpu().numpy())) < 1e-6
    assert torch.equal(out[0], out[1])
    assert np.median(rel(one)) > 1e-5


@pytest.mark.parametrize("scheme", ["fma", "3xtf32", "f64tc", "tf32"])
def test_probe_f32_product_at_k4_stage1(rng, dev, scheme):
    """P1 at the shape the probe tool times, K4's stage 1 over a production
    block (one 48-row tile, 512 copies): every batch copy equals copy 0,
    and copy 0 is within median relative error 1e-6 of the plain version
    (1xTF32: above 1e-5, within its rounding bound)."""
    from bioem_tpu_torch.tools.kernel_probe import K4_STAGE1, tf32_bound

    m, k, n, batch = K4_STAGE1
    ta = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32), device=dev)
    tb = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32), device=dev)
    out = PR.f32_product(ta, tb, scheme=scheme, batch=batch)
    want = PR.f32_product_plain(ta, tb, batch)
    assert out.shape == (batch, m, n)
    assert torch.equal(out, out[:1].expand_as(out))
    med = float(((out[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)).median())
    if scheme == "tf32":
        assert med > 1e-5
        assert bool(((out[0] - want[0]).abs() <= tf32_bound(ta, tb)).all())
    else:
        assert med < 1e-6


# Ragged shapes: one element; a ragged 48-row tile, K past one ring stage
# by one, N not a multiple of 4 (4-byte copies); the TPU probe's (two row
# tiles); two row tiles and two slabs of A (K > 224) at N % 4 = 0 with a
# ragged column tile.
RAGGED_P1 = [(1, 1, 1), (47, 225, 1023), (96, 112, 113), (50, 300, 260)]


@pytest.mark.parametrize("shape", RAGGED_P1, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scheme", PR.SCHEMES)
def test_probe_f32_product_ragged(rng, dev, scheme, shape):
    """Every P1 scheme at ragged shapes, three copies: the copies equal bit
    for bit, each within median relative error 1e-6 and max |Δ| ≤
    1e-5·max|C| of the plain version (1xTF32 within its rounding bound)."""
    from bioem_tpu_torch.tools.kernel_probe import tf32_bound

    m, k, n = shape
    ta = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32), device=dev)
    tb = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32), device=dev)
    out = PR.f32_product(ta, tb, scheme=scheme, batch=3)
    want = PR.f32_product_plain(ta, tb, 3)
    torch.cuda.synchronize()
    assert out.shape == (3, m, n)
    assert torch.equal(out, out[:1].expand_as(out))
    if scheme == "tf32":
        assert bool(((out[0] - want[0]).abs() <= tf32_bound(ta, tb)).all())
    else:
        rel = (out[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)
        assert float(rel.median()) < 1e-6
        assert float((out[0] - want[0]).abs().max()) <= 1e-5 * float(want[0].abs().max())


@pytest.mark.parametrize("structure", ["loop", "batched"])
def test_probe_product_sum_structures(rng, dev, structure):
    """P2 against its plain version within the probe tool's bound
    2·updates·2⁻²³·max|out| (a small image count here)."""
    from bioem_tpu_torch.tools.kernel_probe import p2_updates

    n_img, reps = 9, 2
    a = torch.as_tensor(rng.normal(0, 1, (96, 112)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.as_tensor(rng.normal(0, 1, (n_img, 112, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    got = PR.product_sum(a, b, reps=reps, structure=structure)
    want = PR.product_sum_plain(a, b, reps)
    torch.cuda.synchronize()
    updates = p2_updates(structure, n_img, reps, 112)
    assert float((got - want).abs().max()) <= 2 * updates * 2.0 ** -23 * float(want.abs().max())


@pytest.mark.parametrize("n_img", [64, 201])
@pytest.mark.parametrize("structure", ["loop", "batched"])
def test_probe_product_sum_image_counts(rng, dev, structure, n_img):
    """P2 at the probe's image count and at one whose loop slices are
    ragged (804 products in slices of 7), within the probe tool's bound."""
    from bioem_tpu_torch.tools.kernel_probe import p2_updates

    reps = 4
    a = torch.as_tensor(rng.normal(0, 1, (96, 112)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.as_tensor(rng.normal(0, 1, (n_img, 112, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    before = PR.product_sum.launches
    got = PR.product_sum(a, b, reps=reps, structure=structure)
    want = PR.product_sum_plain(a, b, reps)
    torch.cuda.synchronize()
    assert PR.product_sum.launches == before + 1
    tol = 2 * p2_updates(structure, n_img, reps, 112) * 2.0 ** -23 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_probe_body_ablation_full_is_production(rng, dev):
    """P3: the full body is the production K1/K4 instance, bit for bit;
    every ablated variant launches and writes finite, not all-zero outputs
    (a checksum in m; no_gemm's m is 0 by design, its cc being 0, and its
    se the lattice size)."""
    from bioem_tpu_torch.core.posterior import displacement_dft_weights

    n, n_fold, o, c, i = 48, 2, 2, 2, 8
    f, m = n // 2 + 1, n // n_fold
    disp = np.concatenate([np.arange(0, 21, 2), np.arange(-20, 0, 2)]).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    g = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)  # noqa: E731
    r = lambda *s: g(rng.normal(0, 1, s))  # noqa: E731
    args = (r(o, n, f), r(o, n, f), r(c, n, f), r(c, n, f), r(i, n, f), r(i, n, f),
            g(wx.real[:, :m]), g(wx.imag[:, :m]), g(wy.real), g(wy.imag),
            g(np.abs(rng.normal(0, 1e-5, (o * c, i)))), g(np.abs(rng.normal(0, 1e-8, (o * c, i)))))
    kw = dict(a_coef=-1151.5, n_fold=n_fold)
    prod = {"k1": C.fused_compare_block(*args, **kw),
            "k4": C.fused_compare_block_batched(*args, **kw, img_tile=8)}
    for body in ("k1", "k4"):
        full = PR.body_ablation(*args, **kw, body=body, variant="full")
        assert all(torch.equal(x, y) for x, y in zip(full, prod[body])), body
        for variant in ("no_lse", "mm_only", "no_gemm"):
            outs = PR.body_ablation(*args, **kw, body=body, variant=variant)
            torch.cuda.synchronize()
            assert all(bool(torch.isfinite(t.float()).all()) for t in outs), (body, variant)
            assert any(bool((t != 0).any()) for t in outs), (body, variant)
    with pytest.raises(RuntimeError, match="body_ablation"):
        PR.body_ablation(*_cmp_inputs(rng, dev, n_disp=9, i=8), **kw, body="k4", variant="full")


def test_debug_prob_kernel_path_launches_k3(rng, dev):
    """The DEBUG_PROB dump's kernel path runs K3 once per orientation
    block and agrees with the plain path's dump on the card."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.debug_prob import dump_logpro

    eng = BioEMEngine(*_engine_problem(rng), RunConfig(orient_block=3), device=dev)
    before = C.fused_displacement_cc.launches
    lp_k, cc_k = dump_logpro(eng, 1, kernel="kernel")
    assert C.fused_displacement_cc.launches - before == eng.ang_blocks.shape[0]
    lp_p, cc_p = dump_logpro(eng, 1, kernel="plain")
    assert C.fused_displacement_cc.launches - before == eng.ang_blocks.shape[0]
    assert np.abs(cc_k - cc_p).max() < 5e-5 * np.abs(cc_p).max()
    assert np.abs(lp_k - lp_p).max() < 1e-3


# K3 (K1's kernel in its cc-out body): D = 5…61 × folds 1–4 at N = 48,
# N = 15 (folds 1 and 3) and the stride-1 ±30 lattice at N = 224 (M = 224).
K3_SHAPES = ([(d, nf, 48) for d in (5, 9, 21, 35, 61) for nf in (1, 2, 3, 4)]
             + [(5, 1, 15), (5, 3, 15), (61, 1, 224)])


@pytest.mark.parametrize("n_disp,n_fold,n", K3_SHAPES)
def test_k3_widths_and_folds_vs_plain(rng, dev, n_disp, n_fold, n):
    """K3 against displacement_cc_plain within 5e-5 of max|cc|, with image
    counts that end a run of four warpgroups mid-way."""
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=3, c=2, i=7)
    conv = (args[0], args[1])  # a bank of three "orientation·ctf" pairs
    before = C.fused_displacement_cc.launches
    k = C.fused_displacement_cc(*conv, *args[4:10], n_fold=n_fold)
    torch.cuda.synchronize()
    assert C.fused_displacement_cc.launches == before + 1
    p = C.displacement_cc_plain(*conv, *args[4:10], n_fold=n_fold)
    assert k.shape == (3, 7, n_disp, n_disp)
    assert float((k - p).abs().max()) < 5e-5 * float(p.abs().max())


def test_k3_is_deterministic(dev):
    """Two K3 launches on the production block's conv bank give the same
    bits (no atomics)."""
    from bioem_tpu_torch.tools.kernel_probe import production_block_inputs

    args, _a, n_fold = production_block_inputs(dev)
    (o, n, f), c = args[0].shape, args[2].shape[0]
    conv_re = (args[0][:, None] * args[2][None] + args[1][:, None] * args[3][None]).reshape(o * c, n, f)
    conv_im = (args[1][:, None] * args[2][None] - args[0][:, None] * args[3][None]).reshape(o * c, n, f)
    runs = [C.fused_displacement_cc(conv_re, conv_im, *args[4:10], n_fold=n_fold)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


ENGINE_PATHS = {"k1": dict(use_kernels=True),
                "k4": dict(use_kernels=True, fused_batched=True, kernel_img_tile=5),
                "hybrid": dict(use_kernels=True, fused_lse=False)}


def _eager(eng, state=None, stop=None):
    """The kernel branch's eager loop: _block_step block by block."""
    state = eng.initial_state() if state is None else state
    for b in range(eng.ang_blocks.shape[0] if stop is None else stop):
        state = eng._block_step(state, eng.banks, eng.ang_blocks[b], b * eng.o_block,
                                eng.mask_blocks[b])
    return state


def _same_state(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_replayed_pass_is_bit_equal_to_the_eager_loop(rng, dev, path):
    """run() on the card replays the captured block step; its state equals
    the eager loop's bit for bit (per-angle slabs and the padded last block
    included), so logP and the argmax tuples are equal."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    eng = BioEMEngine(*_engine_problem(rng), RunConfig(orient_block=3, **ENGINE_PATHS[path]),
                      device=dev)
    assert eng._replayed() and eng.fused_batched == (path == "k4")
    assert eng.fused_lse == (path != "hybrid") and eng.n_orient_pad > eng.n_orient
    got = eng.run()
    assert eng._graph is not None
    want = _eager(eng)
    assert _same_state(got, want)
    r_got, r_want = eng.results(got), eng.results(want)
    np.testing.assert_array_equal(r_got.log_prob, r_want.log_prob)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(r_got, f), getattr(r_want, f))


def test_checkpoint_resume_under_replay(rng, dev, tmp_path):
    """A run stopped after two blocks (eager) and resumed in a fresh engine
    (replayed from block 2, saving every block) equals the straight
    replayed run bit for bit."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint

    problem = _engine_problem(rng)
    straight = BioEMEngine(*problem, RunConfig(orient_block=3), device=dev)
    want = straight.run()
    cfg = RunConfig(orient_block=3, checkpoint_path=str(tmp_path / "s.npz"), checkpoint_every=1)
    first = BioEMEngine(*problem, cfg, device=dev)
    save_checkpoint(cfg.checkpoint_path, _eager(first, stop=2), 2, first._fingerprint)
    resumed = BioEMEngine(*problem, cfg, device=dev)
    got = resumed.run()
    assert _same_state(got, want)
    _st, nxt = load_checkpoint(cfg.checkpoint_path, resumed._fingerprint)
    assert nxt == resumed.ang_blocks.shape[0]


def test_launch_counters_count_replays(rng, dev):
    """Capture launches nothing; the counters gain the warm-up step's
    launches once and the captured step's at every replay, in run() and in
    time_blocks; a later pass leaves the state an earlier run() returned
    as it was."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    eng = BioEMEngine(*_engine_problem(rng), RunConfig(orient_block=3), device=dev)
    nblk = eng.ang_blocks.shape[0]
    fns = (C.fused_compare_block, P.fourier_project_block)
    before = [fn.launches for fn in fns]
    first = eng.run()
    kept = [x.clone() if x is not None else None for x in first]
    assert [fn.launches - b for fn, b in zip(fns, before)] == [nblk + 1] * 2
    before = [fn.launches for fn in fns]
    second = eng.run()
    assert [fn.launches - b for fn, b in zip(fns, before)] == [nblk] * 2
    before = [fn.launches for fn in fns]
    eng.time_blocks(2 * eng.o_block, repeats=1)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [2 * 2] * 2
    assert _same_state(first, kept) and _same_state(second, kept)


def _more_per_group(rng, model):
    """A model with each of ``model``'s radii twice (twice its points per
    radius group), jittered positions."""
    from bioem_tpu_torch.io.model_io import Model

    pts = np.concatenate([model.points, model.points + rng.normal(0, 0.7, model.points.shape)])
    dens = np.concatenate([model.densities, model.densities])
    return Model(pts.astype(np.float32), np.concatenate([model.radii, model.radii]),
                 dens.astype(np.float32), float(dens.sum()))


@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_replayed_swapped_banks_equal_the_eager_loop(rng, dev, path):
    """A streamed chunk (swap_images) and a ranked model with twice the
    points per radius group (swap_model on a common layout), each replayed
    through the engine's one captured step, equal the eager loop on those
    banks bit for bit; K2's counts in the graph follow the swapped model;
    the engine's own banks give its first pass again."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.io.map_io import _normalize_stack
    from bioem_tpu_torch.rank import common_model_layout

    p, orients, model, images = _engine_problem(rng)
    big = _more_per_group(rng, model)
    lay = common_model_layout(p, [model, big])
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=3, **ENGINE_PATHS[path]),
                      device=dev, model_layout=lay)
    first = eng.run()
    kept = [x.clone() if x is not None else None for x in first]
    other = _normalize_stack(rng.normal(0, 1, images.maps.shape).astype(np.float32))
    for banks in (eng.swap_images(other), eng.swap_model(big)):
        got = eng.run(banks=banks)
        state = eng.initial_state()
        for b in range(eng.ang_blocks.shape[0]):
            state = eng._block_step(state, banks, eng.ang_blocks[b], b * eng.o_block,
                                    eng.mask_blocks[b])
        assert _same_state(got, state)
        assert torch.equal(eng._graph_banks.counts, banks.counts)
    assert int(banks.counts.max()) == 2 * int(eng.banks.counts.max())
    assert _same_state(eng.run(), kept)
    assert eng.captures == 1


def test_streaming_and_ranking_capture_once(rng, dev):
    """run_streaming and rank_models on the card: one capture per engine
    whatever the chunks or models; the streamed chunks equal the whole
    pass and each ranked model its own engine on the same layout (logP to
    1e-12 relative, argmax tuples exact)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.rank import common_model_layout, rank_models
    from bioem_tpu_torch.stream import ArraySource, run_streaming

    p, orients, model, images = _engine_problem(rng, n_img=7)
    cfg = RunConfig(orient_block=3)
    whole = BioEMEngine(p, orients, model, images, cfg, device=dev)
    want = whole.results(whole.run())
    res, perf = run_streaming(p, orients, model, ArraySource(images.maps), cfg, chunk_images=3,
                              device=dev)
    assert perf["chunks"] == 3 and perf["captures"] == 1
    np.testing.assert_allclose(res.log_prob, want.log_prob, rtol=1e-12, atol=0)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f))
    models = [model, _more_per_group(rng, model)]
    _total, per_image, perf = rank_models(p, orients, models, images, cfg, device=dev)
    assert perf["captures"] == 1
    lay = common_model_layout(p, models)
    for m, mod in enumerate(models):
        own = BioEMEngine(p, orients, mod, images, cfg, device=dev, model_layout=lay)
        np.testing.assert_allclose(per_image[m], own.results(own.run()).log_prob, rtol=1e-12, atol=0)


def _one_card_mesh(dev, mi=2, mo=2):
    from bioem_tpu_torch.parallel.mesh import make_bioem_mesh

    return make_bioem_mesh(mi, mo, devices=[torch.device("cuda", dev.index or 0)] * (mi * mo))


def _held_results(got, want, rtol=1e-12):
    np.testing.assert_allclose(got.log_prob, want.log_prob, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.angle_log, want.angle_log, rtol=rtol, atol=0)
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_mesh_on_one_card_matches_single(rng, dev, path):
    """A 2×2 mesh of four slots on one card, each slot its own captured
    graph, equals the single engine on the same branch (logP and the
    per-angle logP to 1e-12 relative, argmax tuples exact)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine

    p, orients, model, images = _engine_problem(rng, n_img=7)
    kw = dict(orient_block=3, **ENGINE_PATHS[path])
    single = BioEMEngine(p, orients, model, images, RunConfig(**kw), device=dev)
    want = single.results(single.run())
    eng = ShardedBioEMEngine(p, orients, model, images,
                             RunConfig(mesh_images=2, mesh_orient=2, **kw), mesh=_one_card_mesh(dev))
    got = eng.results(eng.run())
    assert eng.captures == 4 and all(e._graph is not None for e in eng.slots.values())
    _held_results(got, want)


def test_streamed_mesh_captures_once_per_slot(rng, dev):
    """run_streaming through a 2×2 mesh on one card: one capture per slot
    whatever the chunks, equal to the whole mesh run."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine
    from bioem_tpu_torch.stream import ArraySource, run_streaming

    p, orients, model, images = _engine_problem(rng, n_img=8)
    cfg = RunConfig(orient_block=3, mesh_images=2, mesh_orient=2, kernel_img_tile=2)
    whole = ShardedBioEMEngine(p, orients, model, images, cfg, mesh=_one_card_mesh(dev))
    want = whole.results(whole.run())
    res, perf = run_streaming(p, orients, model, ArraySource(images.maps), cfg, chunk_images=4,
                              device=dev, mesh=_one_card_mesh(dev))
    assert perf["chunks"] == 2 and perf["captures"] == 4
    _held_results(res, want)


def test_ranked_mesh_run(rng, dev):
    """rank_models on a 2×2 mesh on one card: each slot copies every model
    and its K2 counts into its own graph's banks (one capture per slot),
    each model equal to the single engine's ranking."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.rank import rank_models

    p, orients, model, images = _engine_problem(rng, n_img=6)
    models = [model, _more_per_group(rng, model)]
    _t1, _per_1, perf_1 = rank_models(p, orients, models, images, RunConfig(orient_block=3),
                                      device=dev)
    _tm, _per_m, perf = rank_models(
        p, orients, models, images, RunConfig(orient_block=3, mesh_images=2, mesh_orient=2),
        device=dev, mesh=_one_card_mesh(dev))
    assert perf["captures"] == 4
    for got, want in zip(perf["results"], perf_1["results"]):
        _held_results(got, want)


# ---------------------------------------------------------------------------
# The accuracy and scale tools (bioem_tpu_torch/tools) on the card
# ---------------------------------------------------------------------------

# tests/test_golden.py:146-165: the engine's gap to the all-f64 oracle
ORACLE_ATOL = {"case_l_n64": 2e-5, "case_n_n224": 5e-6}


@pytest.mark.parametrize("config", ["plain", "K1", "K4", "hybrid"])
@pytest.mark.parametrize("case", sorted(ORACLE_ATOL))
def test_error_budget_per_configuration(dev, case, config):
    """golden_error_budget on the card: on the case's maps normalised (the
    f32 gate open, so K1 and K4 run) each configuration runs its own
    comparison, within the JAX suite's absolute limit of the f64 oracle and
    50× inside the reference binary's own error at this N; on the case's
    own maps the kernel configurations take the hybrid, held the same way."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.tools.golden_error_budget import budget

    cfg = {"plain": RunConfig(use_kernels=False), "K1": RunConfig(use_kernels=True),
           "K4": RunConfig(use_kernels=True, fused_batched=True,
                           forced=frozenset({"fused_batched"})),
           "hybrid": RunConfig(use_kernels=True, fused_lse=False)}[config]
    raw = budget(case, cfg, device=dev)
    norm = budget(case, cfg, device=dev, normalized=True)
    assert raw.comparison == ("plain" if config == "plain" else "hybrid")
    assert norm.comparison == config
    for b in (raw, norm):
        assert b.eng_orc < ORACLE_ATOL[case]
        assert b.eng_orc < raw.orc_gold / 50


def test_scale_bench_small(dev):
    """scale_bench at a small size with the per-angle slabs: finite logP
    and slabs, the card's peak memory, and the same bits as run_bioem's
    replayed pass on the same problem."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.run import run_bioem
    from bioem_tpu_torch.tools import scale_bench
    from bioem_tpu_torch.tools.problem import build_problem

    kw = dict(n_img=6, n_pix=64, max_disp=6)
    rec = scale_bench.run_one(48, 30, repeats=1, device=dev, **kw)
    assert rec["logp_finite"] and rec["peak_card_mb"] > 0
    p, orients, model, images, _ = build_problem(n_orient=48, **kw)
    p.write_angles = 30
    own, _ = run_bioem(p, orients, model, images, RunConfig(autotune=False), device=dev)
    assert rec["log_prob"].tobytes() == own.log_prob.tobytes()
