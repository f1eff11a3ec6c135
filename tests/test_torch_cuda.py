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
every fold count and several tiles; K1 at lattice widths up to D = 129
(the reference's production grid, D = 81 at N = 224 and 512; D = 107
and 121 at N = 224, which the earlier kernel refused; D = 129 at N =
256), folds 1–4, odd N, M = 224 and image counts that end a run of four
mid-way, and on lattices whose values are all −inf, hold NaN, or whose
first, middle or last row chunk is all −inf (the online merge's guards);
both to the same bits across two launches (K1 also at D = 81, one wide
chunk of 88 rows, and D = 121, two of 64; K3 at both too). K1 and K3 in
wide chunks (two warpgroups a CTA) at one image and at odd image counts,
which leave the last CTA's second warpgroup idle; at D = 81 and 121,
where stage 2 runs on the tensor cores in 3xTF32, on m, Σ exp, argmax
and cc against limits that a 1xTF32 stage 2, computed beside them on the
same inputs, fails. The projection (K2)
also with per-group point counts that skip padding, at its largest N and
to the same bits across two launches. K3 (K1's kernel writing the
lattice) at D = 5…61 and folds 1–4, at N = 15 and at D = 61, 81 and
121, M = 224,
to the same bits across two launches. The raster projection (G4) against
its plain version on blocks of the production model (the projection within
1e-6 of its max pixel, the scale within 1e-6 relative, the snaps equal but
at ties), with all points point-like (stencil_half 0) and with zero-density
padding, and to the same bits across two launches. The engine's replayed
pass (a captured block step) bit-equal to its eager loop for K1, K4, the
hybrid and the raster (G4), through a checkpoint resume too, with launch counters that count
each replay; on swapped banks too (a streamed image chunk, a ranked model
with more points per radius group, whose counts K2 reads), with one
capture per engine under run_streaming and rank_models; a 2×2 mesh of
four slots on one card (one capture each) equal to the single engine on
each branch, streamed and ranked; two slots' captured steps replayed in
turns on two streams, each with its own G1 workspace. The posterior glue
(G1, G2) against its plain versions at the production block, o_block 16,
C = 32, one image, 37 images, O·C = 15, one CTF and O·C = 512: f0, k,
a_u, b_u and the repaired max at 0 ulps, sum_c bit-equal, ssq_c no
farther from f64 than the plain f32 product; three replays of a captured
G1 + G2 bit-equal to the eager calls, G1's ticket counting its launches.
The probes: P1's FMA, 3xTF32 and FP64
schemes at a median relative error below 1e-6 from f64 (the TPU probe's
"multi-pass" line), 1xTF32 within its rounding bound, every scheme at
ragged shapes with its copies equal;
P2's two structures within the f32 summation bound the probe tool states
(``kernel_probe.p2_updates``); P3's full body bit-equal to K1 and K4. The
tools: the error budget of every engine configuration against the all-f64
oracle within the JAX suite's limits, the C2 cut of the production shape
(no kernel configuration farther from the oracle than max(5e-6, the plain
branch's gap)), scale_bench and the benchmark harness at a small size.
"""

import dataclasses

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
# run of four mid-way; D = 81 at N = 224 (the reference's production grid,
# folds 1 and 2) and N = 512, D = 107 and 121 at N = 224 and D = 129 at
# N = 256 (D = 35…121 in wide row chunks on two warpgroups, D = 129 in
# five 32-row chunks on four; compare_cuda.k1_plan); D = 81 and 121 at one
# image (the CTA's second warpgroup idle).
K1_SHAPES = [  # (n_disp, n_fold, n, images)
    (5, 1, 15, 5), (5, 2, 32, 1), (9, 1, 32, 64), (9, 3, 48, 5), (9, 4, 64, 5),
    (21, 2, 48, 201), (21, 1, 224, 5), (30, 1, 64, 5), (35, 1, 48, 5), (35, 2, 80, 7),
    (61, 1, 64, 3), (81, 1, 224, 3), (81, 2, 224, 3), (107, 1, 224, 3), (121, 1, 224, 3),
    (81, 1, 512, 3), (129, 1, 256, 3), (81, 1, 224, 1), (121, 1, 224, 1)]


@pytest.mark.parametrize("n_disp,n_fold,n,n_img", K1_SHAPES)
def test_k1_widths_folds_and_image_counts(rng, dev, n_disp, n_fold, n, n_img):
    """K1 against its plain version at every shape above (m, se rtol 1e-5,
    the argmax exact on ≥ 90 % of the comparisons, cc there rtol 1e-5),
    launched with the tiling k1_plan gives the shape."""
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=2, c=2, i=n_img)
    a_coef = -0.5 * n * n
    before = C.fused_compare_block.launches
    km, ks, kd, kc = C.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)
    torch.cuda.synchronize()
    assert C.fused_compare_block.launches == before + 1
    assert C.fused_compare_block.last_plan[:2] == C.k1_plan(n_disp, n // n_fold, n // 2 + 1,
                                                            n_fold)[:2]
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
    # se carries v's absolute f32 error, |a_coef|·δcc: at N = 224 (a_coef
    # −25088) chip_smoke's production limit, 1.5e-4, applies.
    torch.testing.assert_close(ks, ps, rtol=1e-5 if n <= 80 else 1.5e-4, atol=0)
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,n_fold,n_disp", [(64, 2, 21), (224, 1, 81), (224, 1, 121)])
def test_k1_is_deterministic(rng, dev, n, n_fold, n_disp):
    """Two K1 launches on the same inputs give the same bits (no atomics),
    with one row chunk of 24 rows, with one wide chunk of 88 (D = 81) and
    with two of 64 (D = 121)."""
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=3, c=4, i=30)
    a_coef = (3.0 - n * n) / 2
    runs = [C.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("d,n,inf_chunk", [(81, 224, None), (121, 224, 0), (121, 224, 1),
                                           (129, 256, 0), (129, 256, 2)])
def test_k1_online_merge_guards(rng, dev, d, n, inf_chunk):
    """The online log-sum-exp's −inf and NaN guards in K1's row chunks
    (compare_cuda.k1_rows: D = 81 one wide chunk of 88 rows, D = 121 two of
    64, D = 129 five of 32 on four warpgroups), against the plain version:
    comparisons whose every value is −inf (a_u = 0, b_u = −inf, so u =
    +inf) give m = −inf, argmax 0 and Σ exp NaN; comparisons holding NaN
    (a_u = +inf, b_u = 0: u = ±inf by the sign of cc) give NaN m and se and
    the first NaN's index; with ``inf_chunk`` the rows of that chunk of wx
    are scaled by 1e30 and b_u made negative, so every value of that chunk
    is −inf and the others finite: the chunk adds nothing, first (chunk 0,
    which the later chunks outrank), last (chunk 1 of D = 121) or in the
    middle (chunk 2 of D = 129)."""
    dc = C.k1_rows(d, C.k1_plan(d, n, n // 2 + 1, 1)[0])[1]
    args = list(_cmp_inputs(rng, dev, n=n, n_fold=1, n_disp=d, o=2, c=2, i=6))
    a_u, b_u = args[10].clone(), -args[11].abs()
    a_u[0], b_u[0] = 0.0, -float("inf")
    a_u[1, :3], b_u[1, :3] = float("inf"), 0.0
    args[10], args[11] = a_u, b_u
    if inf_chunk is not None:
        for k in (6, 7):
            w = args[k].clone()
            w[dc * inf_chunk:dc * inf_chunk + dc] *= 1e30
            args[k] = w
    a_coef = -0.5 * n * n
    km, ks, kd, kc = C.fused_compare_block(*args, a_coef=a_coef, n_fold=1)
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=1)
    torch.cuda.synchronize()
    assert bool((pm[0] == -float("inf")).all()) and bool(ps[0].isnan().all())
    assert bool((pd[0] == 0).all()) and bool(pm[1, :3].isnan().all())
    if inf_chunk is not None:
        # the chunk's values are −inf, the others finite
        rows = pd[2:] // d
        assert bool(torch.isfinite(pm[2:]).all()) and bool(torch.isfinite(ps[2:]).all())
        assert not bool(((rows >= dc * inf_chunk) & (rows < dc * inf_chunk + dc)).any())
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0, equal_nan=True)
    torch.testing.assert_close(ks, ps, rtol=1.5e-4, atol=0, equal_nan=True)
    assert torch.equal(kd[0], pd[0]) and torch.equal(kd[1, :3], pd[1, :3])
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    # cc at the argmax within 5e-5 of the max |cc| of its row chunk (the
    # argmax of these inputs often lies where |cc| is small)
    conv_re = (args[0][:, None] * args[2][None] + args[1][:, None] * args[3][None]).flatten(0, 1)
    conv_im = (args[1][:, None] * args[2][None] - args[0][:, None] * args[3][None]).flatten(0, 1)
    lat = C.displacement_cc_plain(conv_re, conv_im, *args[4:10]).abs()
    chunk_max = torch.stack([lat[:, :, r:r + dc].amax((-2, -1)) for r in range(0, d, dc)], -1)
    scale = chunk_max.gather(-1, (pd.long() // d // dc)[..., None])[..., 0]
    assert bool(((kc - pc).abs() <= 5e-5 * scale)[ok].all())


def test_k1_plan_matches_the_library(dev):
    """The wrapper's tiling rule (compare_cuda.k1_smem_bytes) gives the
    kernel library's shared memory (the C formula K1 and K3 both launch
    with)."""
    from bioem_tpu_torch.ops import _build

    lib = _build.load()
    for d, m, f, n_fold in [(21, 112, 113, 2), (5, 15, 8, 1), (35, 48, 41, 1), (61, 64, 33, 1),
                            (21, 224, 113, 1), (9, 12, 25, 4), (61, 224, 113, 1),
                            (81, 224, 113, 1), (81, 112, 113, 2), (107, 224, 113, 1),
                            (121, 224, 113, 1), (81, 512, 257, 1), (129, 256, 129, 1),
                            (129, 128, 129, 2), (33, 48, 25, 1), (35, 24, 25, 2),
                            (63, 64, 33, 1), (65, 224, 113, 1), (88, 224, 113, 1),
                            (89, 224, 113, 1), (121, 56, 113, 4), (128, 224, 113, 4),
                            (145, 224, 113, 1), (147, 224, 113, 1), (239, 224, 113, 1)]:
        for n_wg in (2, 4):
            for kc in (1, 2, 4, 8):
                assert (lib.bioem_fused_compare_smem_bytes(d, m, f, n_fold, n_wg, kc)
                        == C.k1_smem_bytes(d, m, f, n_fold, n_wg, kc)), (d, m, n_wg, kc)


def _reference_block(dev):
    """A block of the reference's production grid (O=8, C=32, I=64, N=224,
    D=81 at stride 1): kernel_probe's random inputs at its scales."""
    from bioem_tpu_torch.tools.kernel_probe import BLOCKS, block_inputs

    return block_inputs(dev, *BLOCKS["reference"])


def test_k1_and_k3_at_the_reference_block(dev):
    """K1 and K3 at the reference grid's block against their plain versions
    (K1: m, se and cc at the argmax as test_k1_widths_folds_and_image_counts
    holds them; K3 within 5e-5 of max|cc|), each launched on two
    warpgroups with K chunks of eight steps, the lattice in one chunk of 88
    rows, whose three 32-row parts read each formed p."""
    args, a_coef, n_fold = _reference_block(dev)
    km, ks, kd, kc = C.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)
    assert C.fused_compare_block.last_plan == (2, 8, 3)
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    torch.cuda.synchronize()
    torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
    torch.testing.assert_close(ks, ps, rtol=1.5e-4, atol=0)
    ok = kd == pd
    assert float(ok.float().mean()) >= 0.9
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)
    del pm, ps, pd, pc
    (o, n, f), c = args[0].shape, args[2].shape[0]
    conv_re = (args[0][:, None] * args[2][None] + args[1][:, None] * args[3][None]).reshape(o * c, n, f)
    conv_im = (args[1][:, None] * args[2][None] - args[0][:, None] * args[3][None]).reshape(o * c, n, f)
    k = C.fused_displacement_cc(conv_re, conv_im, *args[4:10], n_fold=n_fold)
    assert C.fused_displacement_cc.last_plan == (2, 8, 3)
    p = C.displacement_cc_plain(conv_re, conv_im, *args[4:10], n_fold=n_fold)
    torch.cuda.synchronize()
    assert float((k - p).abs().max()) < 5e-5 * float(p.abs().max())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32, round to nearest with ties away (cvt.rna.tf32.f32)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("d", [81, 121])
def test_k1_and_k3_stage2_on_the_tensor_cores(rng, dev, d):
    """K1 and K3 at the wide chunks (D = 81: one of 88 rows; D = 121: two
    of 64), whose stage 2 runs on the tensor cores in 3xTF32, against
    their plain twins at N = 224, and a 1xTF32 stage 2 (the plain version's
    t1 and wy rounded to TF32, the product in f64) fails the same limits
    on the same inputs. The limits and why (CPU emulation of both schemes:
    tests/test_torch_split_precision.py):
    * K3's cc within 5e-6 of max|cc| of the f64 lattice: plain f32 reads
      ~4e-7, a 3xTF32 stage 2 ~3e-7, a 1xTF32 one ~3e-4;
    * m within rtol 1e-5 of the plain version (3xTF32 ~5e-7; 1xTF32 3–4e-4,
      δcc times |a_coef| = 25,088);
    * the log-sum-exp m + log Σ exp within twice the plain version's
      distance from f64 (3xTF32 ~0.5×, 1xTF32 ~300×);
    * Σ exp within rtol 1.5e-4 of the plain version (chip_smoke's limit:
      v's absolute f32 error times e^(v − m));
    * the argmax equal to the plain version's wherever the two best values
      of its lattice lie more than 1e-5·|a_coef| apart (near-ties may
      swap), and cc there within rtol 1e-5."""
    n = 224
    a_coef = (3.0 - n * n) / 2
    args = _cmp_inputs(rng, dev, n=n, n_fold=1, n_disp=d, o=2, c=2, i=6)
    (o, _n, f), c = args[0].shape, args[2].shape[0]
    conv_re = (args[0][:, None] * args[2][None] + args[1][:, None] * args[3][None]).reshape(o * c, n, f)
    conv_im = (args[1][:, None] * args[2][None] - args[0][:, None] * args[3][None]).reshape(o * c, n, f)
    km, ks, kd, kc = C.fused_compare_block(*args, a_coef=a_coef, n_fold=1)
    k3 = C.fused_displacement_cc(conv_re, conv_im, *args[4:10], n_fold=1)
    assert C.fused_compare_block.last_plan[0] == C.fused_displacement_cc.last_plan[0] == 2
    pm, ps, pd, pc = C.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=1)
    cc = C.displacement_cc_plain(conv_re, conv_im, *args[4:10])
    cc64 = C.displacement_cc_plain(conv_re.double(), conv_im.double(),
                                   *(t.double() for t in args[4:10]))
    # the 1xTF32 control: the plain version's t1, stage 2 on TF32 operands
    p_re = conv_re[:, None] * args[4][None] - conv_im[:, None] * args[5][None]
    p_im = conv_re[:, None] * args[5][None] + conv_im[:, None] * args[4][None]
    ein = torch.einsum
    t1r = ein("dm,oimf->oidf", args[6], p_re) - ein("dm,oimf->oidf", args[7], p_im)
    t1i = ein("dm,oimf->oidf", args[6], p_im) + ein("dm,oimf->oidf", args[7], p_re)
    x64 = lambda t: _tf32(t).double()  # noqa: E731
    cc1 = (ein("oidf,ef->oide", x64(t1r), x64(args[8]))
           - ein("oidf,ef->oide", x64(t1i), x64(args[9]))).float()
    torch.cuda.synchronize()

    def lse(lat, au, bu):
        v = a_coef * torch.log1p(au[..., None] * lat.flatten(2) - bu[..., None] * lat.flatten(2) ** 2)
        top = torch.topk(v, 2, dim=-1).values
        return top[..., 0], torch.exp(v - top[..., :1]).sum(-1), top[..., 0] - top[..., 1]

    m64, s64, _gap = lse(cc64, args[10].double(), args[11].double())
    lse64 = m64 + s64.log()
    p_gap = float((pm.double() + ps.double().log() - lse64).abs().max())
    scale = float(cc64.abs().max())

    def limits(lat, m, se):
        return {"cc": float((lat.double() - cc64).abs().max()) < 5e-6 * scale,
                "m": float(((m - pm).abs() / pm.abs()).max()) <= 1e-5,
                "lse": float((m.double() + se.double().log() - lse64).abs().max()) <= 2 * p_gap}

    got = limits(k3, km, ks)
    assert all(got.values()), got
    m1, s1, _ = lse(cc1, args[10], args[11])
    control = limits(cc1, m1, s1)
    assert not any(control.values()), control
    torch.testing.assert_close(ks, ps, rtol=1.5e-4, atol=0)
    _m, _s, gap = lse(cc, args[10], args[11])
    clear = gap > 1e-5 * abs(a_coef)
    assert bool((kd == pd)[clear].all()) and float(clear.float().mean()) >= 0.9
    ok = kd == pd
    torch.testing.assert_close(kc[ok], pc[ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,n_fold,n_disp", [(224, 2, 21), (224, 1, 81), (224, 1, 121)])
def test_k1_last_plan_at_d21_d81_d121(rng, dev, n, n_fold, n_disp):
    """fused_compare_block.last_plan after a launch is compare_cuda's
    k1_last_plan: (warpgroups, K-chunk steps, 32-row parts of the lattice
    that read each formed p), at the production block's D = 21 (1), the
    reference grid's D = 81 (3) and the wide grid's D = 121 (2)."""
    args = _cmp_inputs(rng, dev, n=n, n_fold=n_fold, n_disp=n_disp, o=1, c=2, i=5)
    C.fused_compare_block(*args, a_coef=(3.0 - n * n) / 2, n_fold=n_fold)
    torch.cuda.synchronize()
    assert C.fused_compare_block.last_plan == C.k1_last_plan(n_disp, n // n_fold, n // 2 + 1,
                                                             n_fold)
    assert C.fused_compare_block.last_plan[2] == {21: 1, 81: 3, 121: 2}[n_disp]


def test_probe_body_ablation_at_the_reference_block(dev):
    """P3's bodies of the reference grid's instance (compare_fused_kernel<176,
    2, *>): the full body is K1 bit for bit; the ablated ones, no_stage2
    among them, launch and write finite, not all-zero outputs (no_gemm: m
    0, se the lattice size)."""
    args, a_coef, n_fold = _reference_block(dev)
    kw = dict(a_coef=a_coef, n_fold=n_fold, body="k1")
    prod = C.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)
    full = PR.body_ablation(*args, **kw, variant="full")
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(full, prod))
    for variant in ("no_lse", "mm_only", "no_stage2", "no_gemm"):
        outs = PR.body_ablation(*args, **kw, variant=variant)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t.float()).all()) for t in outs), variant
        assert any(bool((t != 0).any()) for t in outs), variant
    assert bool((outs[0] == 0).all()) and bool((outs[1] == 81 * 81).all())


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
# N = 15 (folds 1 and 3), the stride-1 ±30, ±40 and ±60 lattices at
# N = 224 (M = 224; D = 81 in one wide row chunk, 121 in two).
K3_SHAPES = ([(d, nf, 48) for d in (5, 9, 21, 35, 61) for nf in (1, 2, 3, 4)]
             + [(5, 1, 15), (5, 3, 15), (61, 1, 224), (81, 1, 224), (121, 1, 224)])


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
    assert C.fused_displacement_cc.last_plan[:2] == C.k1_plan(n_disp, n // n_fold, n // 2 + 1,
                                                              n_fold)[:2]
    p = C.displacement_cc_plain(*conv, *args[4:10], n_fold=n_fold)
    assert k.shape == (3, 7, n_disp, n_disp)
    assert float((k - p).abs().max()) < 5e-5 * float(p.abs().max())


@pytest.mark.parametrize("n_disp,n_img", [(81, 1), (81, 5), (121, 1), (121, 5)])
def test_k3_wide_chunks_at_one_and_odd_image_counts(rng, dev, n_disp, n_img):
    """K3 in wide row chunks (two warpgroups a CTA, one image each) at one
    image and at five, where the last CTA's second warpgroup computes on a
    copy and writes nothing: within 5e-5 of max|cc| of its plain version,
    and two launches to the same bits."""
    n = 224
    args = _cmp_inputs(rng, dev, n=n, n_fold=1, n_disp=n_disp, o=3, c=2, i=n_img)
    conv = (args[0], args[1])
    runs = [C.fused_displacement_cc(*conv, *args[4:10], n_fold=1) for _ in range(2)]
    torch.cuda.synchronize()
    assert C.fused_displacement_cc.last_plan == C.k1_last_plan(n_disp, n, n // 2 + 1, 1)
    assert C.fused_displacement_cc.last_plan[0] == 2
    assert torch.equal(runs[0], runs[1])
    p = C.displacement_cc_plain(*conv, *args[4:10], n_fold=1)
    assert runs[0].shape == (3, n_img, n_disp, n_disp)
    assert float((runs[0] - p).abs().max()) < 5e-5 * float(p.abs().max())


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
                "hybrid": dict(use_kernels=True, fused_lse=False),
                "raster": dict(use_kernels=True, projection="raster")}


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
    fns = (C.fused_compare_block, P.fourier_project_block, P.project_prologue)
    before = [fn.launches for fn in fns]
    first = eng.run()
    kept = [x.clone() if x is not None else None for x in first]
    assert [fn.launches - b for fn, b in zip(fns, before)] == [nblk + 1] * 3
    before = [fn.launches for fn in fns]
    second = eng.run()
    assert [fn.launches - b for fn, b in zip(fns, before)] == [nblk] * 3
    before = [fn.launches for fn in fns]
    eng.time_blocks(2 * eng.o_block, repeats=1)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [2 * 2] * 3
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


# C2: the production shape cut to 4 planted images × their 16 nearest
# orientations × 8 CTFs (N = 224, D = 21 at stride 2): no kernel
# configuration farther from the all-f64 oracle than max(5e-6, the plain
# branch's gap on the same cut). 5e-6 is the JAX suite's limit at N = 224.
C2_ATOL = 5e-6


def test_c2_cut_against_the_oracle(dev):
    """Plain, K1, K4 and the hybrid on the C2 cut: each ran its own
    comparison, argmax tuples equal to the plain branch's, and no kernel
    configuration farther from the oracle than max(5e-6, plain's gap)."""
    from bioem_tpu_torch.tools.golden_error_budget import cut_gaps
    from bioem_tpu_torch.tools.problem import build_problem, orientation_cut

    cut = orientation_cut(build_problem(n_img=4), 4)
    _lp, rows = cut_gaps(cut, device=dev)
    limit = max(C2_ATOL, rows["plain"]["engine_vs_oracle"])
    plain = rows["plain"]["results"]
    for name, r in rows.items():
        assert r["ran"] == name
        assert r["engine_vs_oracle"] <= limit, (name, r["engine_vs_oracle"], limit)
        for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
            np.testing.assert_array_equal(getattr(r["results"], f), getattr(plain, f))
    np.testing.assert_array_equal(plain.best_orient, cut[4]["orient"])


@pytest.mark.parametrize("problem", ["bench", "planted"])
def test_bench_harness_small(dev, monkeypatch, capsys, tmp_path, problem):
    """The benchmark harness at a small size on the card: one JSON line
    with every key, the card named with its power limit, a kernel
    configuration, and the pass at or above its bound."""
    import json

    from bioem_tpu_torch.tools import bench

    monkeypatch.setenv("BIOEM_TPU_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    for k, v in (("N_PIXELS", 64), ("N_IMG", 8), ("QUAT_GRID", 4), ("REPEATS", 1),
                 ("BASELINE_SAMPLE_OC", 1)):
        monkeypatch.setattr(bench, k, v)
    assert bench.main(["--problem", problem]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "baseline_kind",
                "max_abs_dlogp_vs_reference", "accuracy_cases",
                "max_abs_dlogp_vs_reference_n224", "problem", "comparison", "config",
                "autotune_s", "comparisons", "seconds", "device_kind",
                "useful_f32_flops_per_comparison", "achieved_useful_tflops", "bound_s",
                "bound_by", "roofline_pct", "card"):
        assert key in rec, key
    assert rec["problem"] == problem and rec["comparison"] in ("K1", "K4", "hybrid")
    assert rec["card"].startswith(torch.cuda.get_device_name(0)) and rec["card"].endswith("W")
    assert rec["value"] > 0 and 0 < rec["roofline_pct"] <= 100


# ---------------------------------------------------------------------------
# The posterior glue: G1 (block_constants) and G2 (merge_block)
# ---------------------------------------------------------------------------

# (O, C, I): the production block, o_block 16, a reference-grid block;
# then one image, an image count that fills no power of two, O·C not a
# multiple of 32, one CTF, and O·C = 512 (G2's one thread per pair at most)
GLUE_SHAPES = [(8, 8, 64), (16, 8, 64), (8, 32, 64)]
GLUE_EDGE_SHAPES = [(8, 8, 1), (8, 8, 37), (3, 5, 37), (8, 1, 64), (16, 32, 64)]


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("shape", GLUE_SHAPES + GLUE_EDGE_SHAPES)
def test_block_constants_kernel_vs_plain(dev, shape, normalized):
    """G1 against its plain version: sum_c bit-equal; ssq_c (f64 sum
    against an f32 product) within 2e-6 relative and no farther from an
    all-f64 evaluation; f0, k, a_u, b_u at 0 ulps from the plain formulas on
    G1's own sums (the same libdevice functions and roundings); the masked
    orientation's k exactly −inf; the workspace's ticket advanced by one
    launch's CTAs."""
    from bioem_tpu_torch.ops import posterior_cuda as G
    from bioem_tpu_torch.tools.kernel_probe import glue_inputs, ulp_distance

    x = glue_inputs(dev, *shape, normalized=normalized)
    ws = G.constants_workspace(*shape, 224, 113, dev)
    before = G.block_constants.launches
    sum_c, ssq_c, f0, k, a_u, b_u = G.block_constants(*x["g1"], **x["kw"], workspace=ws)
    torch.cuda.synchronize()
    assert G.block_constants.launches == before + 1
    assert ws.ticket.tolist() == [ws.plan.grid]
    p_sum, p_ssq = G.convolution_sums_plain(*x["g1"][:5], ntot=x["kw"]["ntot"])
    assert torch.equal(sum_c, p_sum)
    assert float(((ssq_c - p_ssq).abs() / p_ssq.abs()).max()) <= 2e-6
    _s64, ssq64 = G.convolution_sums_plain(*(v.double() for v in x["g1"][:5]),
                                           ntot=x["kw"]["ntot"])
    assert (ssq_c.double() - ssq64).abs().max() <= (p_ssq.double() - ssq64).abs().max()
    want = G.constants_from_sums(sum_c, ssq_c, *x["g1"][5:], **x["kw"])
    for name, a, b in zip(("f0", "k", "a_u", "b_u"), (f0, k, a_u, b_u), want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert ulp_distance(a, b) == 0, name
    assert bool((k[-1] == -torch.inf).all()) and bool(torch.isfinite(k[:-1]).all())


def _merge_pair(dev, shape, case, slabs):
    """A state after one fused block merged by the plain version, then the
    ``case`` block merged into a copy by G2 (offset a 0-d tensor) and into
    another by the plain version (an int): (kernel state, plain state,
    the state before, G2's m_out, the plain version's m)."""
    from bioem_tpu_torch.core.posterior import init_state
    from bioem_tpu_torch.ops import posterior_cuda as G
    from bioem_tpu_torch.tools.kernel_probe import glue_inputs, glue_merge_args

    o, _c, i = shape
    x = glue_inputs(dev, *shape)
    ntot = x["kw"]["ntot"]
    base = init_state(i, 2 * o, slabs, dev)
    G.merge_block_plain(base, *glue_merge_args(glue_inputs(dev, *shape, seed=7), "fused"), 0,
                        ntot=ntot)
    args = glue_merge_args(x, case)
    kern, plain = ([x.clone() if x is not None else None for x in base] for _ in range(2))
    kern, plain = type(base)(*kern), type(base)(*plain)
    m_k = torch.empty(args[4].shape, dtype=torch.float64, device=dev)
    m_p = torch.empty_like(m_k)
    before = G.merge_block.launches
    G.merge_block(kern, *args, torch.tensor(o, device=dev), ntot=ntot, m_out=m_k)
    G.merge_block_plain(plain, *args, o, ntot=ntot, m_out=m_p)
    torch.cuda.synchronize()
    assert G.merge_block.launches == before + 1
    return kern, plain, base, m_k, m_p


@pytest.mark.parametrize("slabs", [False, True])
@pytest.mark.parametrize("case", ["fused", "hybrid", "partial", "full", "ties"])
@pytest.mark.parametrize("shape", GLUE_SHAPES + GLUE_EDGE_SHAPES)
def test_merge_block_kernel_vs_plain(dev, shape, case, slabs):
    """G2 against its plain version: the repaired m at 0 ulps from
    refine_varying_max (the same libdevice log1p); const, best_orient,
    best_conv, best_cent_x/y and ang_const exact; best_norm and best_mu
    within 1e-12 relative; total and ang_total within 1e-6 relative (an
    f64 sum of the f32 products against torch's f32 sum); a fully masked
    block leaves the state bit-equal; ties go to the first pair."""
    from bioem_tpu_torch.tools.kernel_probe import ulp_distance

    kern, plain, base, m_k, m_p = _merge_pair(dev, shape, case, slabs)
    assert ulp_distance(m_k, m_p) == 0
    if case == "full":
        assert all(x is None or torch.equal(x, y) for x, y in zip(kern, base))
    for name, a, b in zip(kern._fields, kern, plain):
        if a is None:
            assert b is None and (name.startswith("ang") and not slabs), name
        elif name in ("total", "ang_total"):
            assert bool(((a - b).abs() <= 1e-6 * b.abs()).all()), name
        elif name in ("best_norm", "best_mu"):
            assert float(((a - b).abs() / b.abs().clamp_min(1e-300)).max()) <= 1e-12, name
        else:
            assert torch.equal(a, b), name
    if case == "ties":
        assert bool((kern.best_orient == shape[0]).all() and (kern.best_conv == 0).all())


def test_glue_replays_read_the_device_offset(dev):
    """G1 and G2 captured in one CUDA graph on static inputs, the block's
    orientation offset a 0-d device tensor that the graph advances, G1's
    workspace made before the capture: three replays, each on another
    block's inputs copied in, equal G1 and G2 called eagerly with int
    offsets 0, O and 2·O, bit for bit (an offset frozen at capture would
    put every later winner at orientation < O; a ticket that G1 took for
    another launch's would leave the later replays' constants unwritten),
    the ticket advanced by one launch's CTAs per launch (the warm-up, the
    replays and none at the capture)."""
    from bioem_tpu_torch.tools.kernel_probe import glue_replay

    state, eager, blk, ws = glue_replay(dev, n_blocks=3)
    assert blk == 3
    assert all(torch.equal(a, b) for a, b in zip(state, eager))
    assert bool((state.best_orient >= 8).any())
    assert ws.ticket.tolist() == [(1 + 3) * ws.plan.grid]


def test_two_slots_on_one_card_keep_their_own_workspaces(rng, dev):
    """The two slots of a 1×2 mesh on one card, each with its own captured
    step and G1 workspace, replayed in turns on two streams: each slot's
    state bit-equal to its replays alone."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine

    p, orients, model, images = _engine_problem(rng, n_img=7)
    mesh = ShardedBioEMEngine(p, orients, model, images,
                              RunConfig(orient_block=3, mesh_images=1, mesh_orient=2),
                              mesh=_one_card_mesh(dev, 1, 2))
    a, b = mesh.slots.values()
    assert a._g1_workspace.ws.data_ptr() != b._g1_workspace.ws.data_ptr()
    assert a._g1_workspace.ticket.data_ptr() != b._g1_workspace.ticket.data_ptr()
    alone = [e.run() for e in (a, b)]
    nblk = a.ang_blocks.shape[0]
    assert b.ang_blocks.shape[0] == nblk
    states = [e._graph_load(e.initial_state(), 0) for e in (a, b)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _blk in range(nblk):
        for e, s in zip((a, b), streams):
            with torch.cuda.stream(s):
                e._replay()
    for s in streams:
        torch.cuda.current_stream(dev).wait_stream(s)
    torch.cuda.synchronize(dev)
    for got, want in zip(states, alone):
        assert _same_state(got, want)


def test_glue_wrappers_reject_bad_input(dev):
    from bioem_tpu_torch.core.posterior import init_state
    from bioem_tpu_torch.ops import posterior_cuda as G
    from bioem_tpu_torch.tools.kernel_probe import glue_inputs, glue_merge_args

    x = glue_inputs(dev, 2, 3, 8, n=32)
    g1 = list(x["g1"])
    with pytest.raises(ValueError, match="pr must be"):
        G.block_constants(g1[0].double(), *g1[1:], **x["kw"])
    with pytest.raises(ValueError, match="mask must be"):
        G.block_constants(*g1[:8], g1[8].long(), **x["kw"])
    args = list(glue_merge_args(x, "fused"))
    st = init_state(8, 4, True, dev)
    with pytest.raises(ValueError, match="se must be contiguous"):
        G.merge_block(st, None, args[1].transpose(0, 1).contiguous().transpose(0, 1), *args[2:],
                      0, ntot=x["kw"]["ntot"])
    with pytest.raises(ValueError, match="orient_offset must be"):
        G.merge_block(st, *args, torch.zeros(1, dtype=torch.long, device=dev),
                      ntot=x["kw"]["ntot"])
    with pytest.raises(ValueError, match="state.total must be"):
        G.merge_block(init_state(4, 4, True, dev), *args, 0, ntot=x["kw"]["ntot"])
    with pytest.raises(ValueError, match="m must be"):
        G.merge_block(st, args[4].clone(), *args[1:], 0, ntot=x["kw"]["ntot"])
    with pytest.raises(IndexError, match="outside the slab"):
        G.merge_block(st, *args, 0, ntot=x["kw"]["ntot"], ang_offset=3)


# ---------------------------------------------------------------------------
# The projection's prologue: G3 (project_prologue) and K2's scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["production", "euler", "o_block 16", "reference grid",
                                  "out of frame"])
def test_project_prologue_kernel_vs_plain(dev, case):
    """G3 against its plain version on blocks of the production model
    (kernel_probe.prologue_inputs): i0 and j0 equal except where the plain
    version's value x/pix + N/2 + 0.5 lies within 2 ulps of an integer (its
    rotation's dot product goes to cuBLAS in an order G3 cannot know; the
    count of such slots is printed); the densities equal wherever the
    snaps are; the scale within 1e-6 relative of the plain one (an f64 sum
    against torch's f32 sums) and of norm_den/tempden on G3's own
    densities; two launches bit-equal; out of the frame, points dropped in
    both branches."""
    from bioem_tpu_torch.tools.kernel_probe import check_prologue, prologue_inputs

    x = prologue_inputs(dev, case)
    before = P.project_prologue.launches
    r = check_prologue(x)
    assert P.project_prologue.launches == before + 2
    print(f"G3 {case}: {r['differ']} of {r['slots']} slots snap elsewhere than the plain "
          f"version (all at ties: {r['off_tie'] == 0}); scale max rel |Δ| {r['scale_rel']:.2e}")
    assert r["off_tie"] == 0 and r["dens_off"] == 0 and r["bits"]
    assert r["scale_rel"] <= 1e-6 and r["scale_rel_own"] <= 1e-6
    if case == "out of frame":
        assert r["dropped"]["point"] > 0 and r["dropped"]["sphere"] > 0


def test_k2_scale_is_one_product(dev):
    """K2 given G3's scale stores, bit for bit, its unscaled spectra times
    the scale: the product the caller rounded before K2 took it."""
    from bioem_tpu_torch.tools.kernel_probe import prologue_inputs

    x = prologue_inputs(dev)
    i0, j0, de, scale = P.project_prologue(x["fspec"], x["angles"], *x["model"], x["st_sums"],
                                           use_quaternions=True)
    kw = dict(n=x["fspec"].n_pixels, counts=x["counts"])
    ur, ui = P.fourier_project_block(i0, j0, de, x["st_re"], x["st_im"], **kw)
    sr, si = P.fourier_project_block(i0, j0, de, x["st_re"], x["st_im"], scale=scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sr, ur * scale[:, None, None]) and torch.equal(si, ui * scale[:, None, None])


def test_projection_replays_equal_the_eager_calls(dev):
    """G3 + K2 captured in one graph on a static angle block: two replays,
    each on another block's rows copied in, equal the eager calls bit for
    bit (and differ from each other)."""
    from bioem_tpu_torch.tools.kernel_probe import prologue_replay

    replayed, eager = prologue_replay(dev)
    for got, want in zip(replayed, eager):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(replayed[0][0], replayed[1][0])


def test_project_prologue_time_and_bound(dev):
    """G3's card time beside its plain version's and its bound (bytes: the
    model's slots read, (G, O, Pp) ×3 and the scale written once) at the
    production block, each on the card's own time."""
    from bioem_tpu_torch.tools.kernel_probe import device_ms, prologue_inputs
    from bioem_tpu_torch.tools.problem import prologue_bound

    x = prologue_inputs(dev)
    args = (x["fspec"], x["angles"], *x["model"], x["st_sums"])
    ms = device_ms(lambda: P.project_prologue(*args, use_quaternions=True))
    plain = device_ms(lambda: P.project_prologue_plain(*args, use_quaternions=True), 5)
    b = prologue_bound(x["angles"].shape[0], x["fspec"].n_groups, x["fspec"].group_pad)
    print(f"G3 production block: {ms:.4f} ms, plain {plain:.4f} ms, bound {b[0]:.6f} ms ({b[1]})")
    assert 0 < b[0] < ms and plain > 0


def test_project_prologue_rejects_bad_input(dev):
    from bioem_tpu_torch.tools.kernel_probe import prologue_inputs

    x = prologue_inputs(dev)
    fs, ang, model, sums = x["fspec"], x["angles"], x["model"], x["st_sums"]
    with pytest.raises(ValueError, match="angles must be"):
        P.project_prologue(fs, ang.double(), *model, sums, use_quaternions=True)
    with pytest.raises(ValueError, match="angles must be contiguous"):
        P.project_prologue(fs, ang.t().contiguous().t(), *model, sums, use_quaternions=True)
    with pytest.raises(ValueError, match="norm_den must be"):
        P.project_prologue(fs, ang, *model[:3], model[3][None], sums, use_quaternions=True)
    i0, j0, de, scale = P.project_prologue(fs, ang, *model, sums, use_quaternions=True)
    with pytest.raises(ValueError, match="scale must be"):
        P.fourier_project_block(i0, j0, de, x["st_re"], x["st_im"], n=fs.n_pixels,
                                counts=x["counts"], scale=scale[:4])


# ---------------------------------------------------------------------------
# The raster projection: G4 (raster_project)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["production", "euler", "o_block 16", "reference grid",
                                  "out of frame"])
def test_raster_kernel_vs_plain(dev, case):
    """G4 against its plain version (rotation_matrices, then project_batch:
    index_add_'s atomics) on blocks of the production model
    (kernel_probe.raster_inputs): the snapped pixels equal except where the
    plain version's value lies within 2 ulps of an integer; on the
    orientations whose snaps all agree the projection within 1e-6 of the
    plain version's max |pixel| (the deposit in model order against the
    atomics' order, tempden in f64 against torch's f32 sum) and the scale
    within 1e-6 relative; two launches bit-equal; out of the frame, points
    dropped in both branches."""
    from bioem_tpu_torch.tools.kernel_probe import check_raster, raster_inputs

    x = raster_inputs(dev, case)
    assert x["spec"].stencil_half == 4
    before = P.raster_project.launches
    r = check_raster(x)
    assert P.raster_project.launches == before + 2
    print(f"G4 {case}: {r['differ']} of {r['pairs']} pairs snap elsewhere than the plain "
          f"version (all at ties: {r['off_tie'] == 0}); projection max |Δ| {r['proj_rel']:.2e} "
          f"of max |pixel|; scale max rel |Δ| {r['scale_rel']:.2e}")
    assert r["off_tie"] == 0 and r["bits"]
    assert r["proj_rel"] <= 1e-6 and r["scale_rel"] <= 1e-6
    if case == "out of frame":
        assert r["dropped"]["point"] > 0 and r["dropped"]["sphere"] > 0


@pytest.mark.parametrize("layout", ["point-like", "padded"])
def test_raster_kernel_stencil_zero_and_padding(rng, dev, layout):
    """G4 where every point is point-like (stencil_half 0: spheres would
    deposit nothing) and on a zero-density padded layout with a wider
    stencil than the model needs (rank.common_model_layout of a
    mixed-radius pair), against the plain version within 1e-6 of its max
    |pixel|; two launches bit-equal."""
    from bioem_tpu_torch.core.projection import make_projection_spec
    from bioem_tpu_torch.rank import common_model_layout
    from bioem_tpu_torch.tools.kernel_probe import _case_block

    p, ang, quat, model = _case_block("production")
    pts, radii, dens = model.points, model.radii, model.densities
    if layout == "point-like":
        radii = np.full_like(radii, np.float32(0.5 * p.pixel_size))
        spec = make_projection_spec(p, radii)
        assert spec.stencil_half == 0
    else:
        wide = radii * np.float32(1.5)
        lay = common_model_layout(p, [model, type(model)(pts[:300], wide[:300], dens[:300],
                                                         float(dens[:300].sum()))])
        spec = make_projection_spec(p, radii, stencil_half_min=lay["stencil_half"])
        assert spec.stencil_half > make_projection_spec(p, radii).stencil_half
        pad = 64
        pts = np.concatenate([pts, np.repeat(pts[:1], pad, 0)])
        radii = np.concatenate([radii, np.repeat(radii[:1], pad)])
        dens = np.concatenate([dens, np.zeros(pad, np.float32)])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    args = (spec, t(ang), t(pts), t(radii), t(dens),
            torch.tensor(np.float32(model.norm_den), device=dev))
    got = P.raster_project(*args, use_quaternions=quat)
    again = P.raster_project(*args, use_quaternions=quat)
    want = P.raster_project_plain(*args, use_quaternions=quat)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_raster_reach_matches_the_library(dev):
    """G4's reach in the wrapper (RASTER_MAX_N, RASTER_MAX_STENCIL_HALF) is
    the library's; past it the wrapper raises."""
    import dataclasses

    from bioem_tpu_torch.ops import _build
    from bioem_tpu_torch.tools.kernel_probe import raster_inputs

    assert _build.load().bioem_raster_max_stencil_half() == P.RASTER_MAX_STENCIL_HALF
    x = raster_inputs(dev)
    for field, value, what in (("n_pixels", P.RASTER_MAX_N + 1, "too large"),
                               ("stencil_half", P.RASTER_MAX_STENCIL_HALF + 1, "stencil_half")):
        spec = dataclasses.replace(x["spec"], **{field: value})
        with pytest.raises(ValueError, match=what):
            P.raster_project(spec, x["angles"], *x["model"], use_quaternions=True)
    with pytest.raises(ValueError, match="angles must be"):
        P.raster_project(x["spec"], x["angles"].double(), *x["model"], use_quaternions=True)


@pytest.mark.parametrize("wide", [False, True])
def test_raster_weights_and_snaps_bit_equal(dev, wide):
    """G4's bucketed deposit against the plain version bit for bit where
    no two stencils meet (kernel_probe.check_raster_sparse: a sheet of
    points of radii from point-like to 3.4 pixels, rotated about z; wide:
    radii to 31.5 pixels, a reach past the deposit's octant table): every
    snap equal, every pixel the plain version's weight times G4's scale,
    the scale within 1e-6 of the plain version's."""
    from bioem_tpu_torch.tools.kernel_probe import check_raster_sparse

    r = check_raster_sparse(dev, wide)
    assert r["stencil_half"] == (32 if wide else 4)
    assert r["snaps_equal"] and r["weights_equal"], r
    assert r["scale_rel"] <= 1e-6


@pytest.mark.parametrize("box", [32, 48])
def test_raster_voxel_map_vs_plain(dev, box):
    """A voxel map (kernel_probe.synthetic_map: every voxel a sphere of
    radius 2·pix, a noisy density, corners out of the frame) through G4
    against the plain version, as test_raster_kernel_vs_plain holds the
    production model: snaps equal but at ties, every pixel within f32
    reordering's bound of the plain version's (each pixel sums ~9·box
    weights of both signs, so 1e-6 of the max pixel no longer holds at
    48³), the scale within 1e-6, two launches bit-equal, points dropped out
    of the frame."""
    from bioem_tpu_torch.tools.kernel_probe import check_raster, map_inputs

    x = map_inputs(dev, box)
    assert x["spec"].stencil_half == 3
    r = check_raster(x)
    assert r["off_tie"] == 0 and r["bits"], r
    assert r["reorder_ok"] and r["scale_rel"] <= 1e-6, r
    assert r["dropped"]["sphere"] > 0


@pytest.mark.parametrize("row", [0, 7])
def test_raster_map224_rows_vs_plain(dev, row):
    """G4 on a whole block of the 224³ map (8 orientations: the map's tile
    and entry offsets), one row held against the plain version as
    test_raster_voxel_map_vs_plain holds the small maps: snaps equal but
    at ties, every pixel within f32 reordering's bound, the scale within
    1e-6, two launches bit-equal."""
    from bioem_tpu_torch.tools.kernel_probe import check_raster, map_inputs

    r = check_raster(map_inputs(dev, 224), [row])
    assert r["pairs"] == 224 ** 3 and r["compared"] == 1, r
    assert r["off_tie"] == 0 and r["bits"], r
    assert r["reorder_ok"] and r["scale_rel"] <= 1e-6, r


def test_raster_map224_block_runs(dev):
    """One block of a 224³ map (11,239,424 voxels, 8 orientations), in each
    of G4's variants: two launches bit-equal, every pixel finite, each
    projection summing to norm_den within f32's sums; the generic variant
    in six kernel launches a call, the lattice variant in two."""
    from bioem_tpu_torch.tools.kernel_probe import raster_map_block

    r = raster_map_block(dev, reps=1)
    assert r["points"] == 224 ** 3
    for name, kernels in (("generic", 6), ("lattice", 2)):
        v = r[name]
        assert v["bits"] and v["finite"] and v["sum_rel"] < 1e-4, (name, v)
        assert v["kernels"] == kernels, (name, v)


# G4's lattice variant: (box, shift) of kernel_probe.map_inputs, each on
# kernel_probe.lattice_angles (axis-aligned, 45° about each axis, a body
# diagonal, random rotations with their −q)
LATTICE_MAPS = [(32, (0, 0)), (48, (2, -3)), ((33, 40, 27), (-1, 2))]


@pytest.mark.parametrize("box,shift", LATTICE_MAPS, ids=lambda v: str(v))
def test_raster_lattice_vs_generic_and_plain(dev, box, shift):
    """G4's lattice variant (kernel_probe.check_raster_lattice) on a voxel
    map: every snap it writes bit-equal to the generic variant's and every
    in-frame snap of the generic variant written; the scale within one f32
    ulp of the generic variant's and within 1e-6 of the plain version's;
    every pixel within f32 reordering's bound of the plain version's; two
    launches bit-equal; q and −q give the same projection."""
    from bioem_tpu_torch.tools.kernel_probe import (check_raster_lattice, lattice_angles,
                                                    map_inputs)

    ang = lattice_angles()
    x = map_inputs(dev, box, angles=ang, shift=shift)
    before = P.raster_project.launches
    r = check_raster_lattice(x)
    assert P.raster_project.launches == before + 4
    assert r["snaps_equal"] and r["scale_ulps"] <= 1, r
    assert r["off_tie"] == 0 and r["bits"] and r["reorder_ok"], r
    assert r["compared"] > 0 and r["scale_rel"] <= 1e-6, r
    out = P.raster_project(x["spec"], x["angles"], *x["model"], use_quaternions=True,
                           lattice=x["lattice"])
    for k in range(6, ang.shape[0], 2):
        assert torch.equal(out[k], out[k + 1]), k


@pytest.mark.parametrize("row", [0, 7])
def test_raster_lattice_map224_rows(dev, row):
    """The lattice variant on a whole block of the 224³ map, one row held
    against the plain version and the generic variant as
    test_raster_lattice_vs_generic_and_plain holds the small maps."""
    from bioem_tpu_torch.tools.kernel_probe import check_raster_lattice, map_inputs

    r = check_raster_lattice(map_inputs(dev, 224), [row])
    assert r["pairs"] == 224 ** 3 and r["compared"] == 1, r
    assert r["snaps_equal"] and r["scale_ulps"] <= 1, r
    assert r["off_tie"] == 0 and r["bits"] and r["reorder_ok"], r


def test_raster_lattice_reach_matches_the_library(dev):
    """The lattice variant's widest reach, tile and walk margin in the
    wrapper (which the CPU twin of its walk reads) are the library's; a
    lattice whose radius reaches further, or one with more voxels than
    points, is refused."""
    from bioem_tpu_torch.ops import _build
    from bioem_tpu_torch.tools.kernel_probe import map_inputs

    lib = _build.load()
    assert lib.bioem_raster_lattice_max_reach() == P.RASTER_LATTICE_MAX_REACH
    assert lib.bioem_raster_lattice_tile() == P.RASTER_LATTICE_TILE
    assert lib.bioem_raster_lattice_margin() == P.RASTER_LATTICE_MARGIN
    x = map_inputs(dev, 32)
    axes, shape, radius = x["lattice"]
    pix = float(np.float32(x["spec"].pixel_size))
    wide = (axes, shape, 4.5 * pix)
    spec = dataclasses.replace(x["spec"], stencil_half=6)
    with pytest.raises(RuntimeError, match="raster_project"):
        P.raster_project(spec, x["angles"], *x["model"], use_quaternions=True, lattice=wide)
    with pytest.raises(ValueError, match="exceeds"):
        P.raster_project(x["spec"], x["angles"], *x["model"], use_quaternions=True,
                         lattice=(torch.cat([axes, axes[:1]]), (33, 32, 32), radius))


def test_engine_takes_the_lattice_variant_on_a_map(dev):
    """A 24³ map on the card's kernel branch: the engine lays it out on the
    lattice variant (counter bioem.projection.raster.lattice), each replay
    launches G4 once, and log P equals the same engine on the generic
    variant (layout lattice False) within 1e-7 of max |log P| (the two
    differ only in the order of each pixel's f32 sums; the port and the JAX
    package's raster differ by 8.6e-9 of it on a 32³ map), argmax tuples
    equal."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.tools.kernel_probe import synthetic_map
    from bioem_tpu_torch.utils.timestat import RECORDER

    p, orients, _model, images = _engine_problem(np.random.default_rng(3), n_pix=32)
    model = synthetic_map(24, p.pixel_size)
    cfg = RunConfig(orient_block=4, projection="raster", autotune=False)
    before = RECORDER.count("bioem.projection.raster.lattice")
    eng = BioEMEngine(p, orients, model, images, cfg, device=dev)
    assert eng.lattice == ((24, 24, 24), float(model.radii[0]))
    assert RECORDER.count("bioem.projection.raster.lattice") == before + 1
    gen = BioEMEngine(p, orients, model, images, cfg, device=dev,
                      model_layout={"lattice": False})
    assert gen.lattice is None
    launches = P.raster_project.launches
    got = eng.results(eng.run())
    assert P.raster_project.launches - launches == eng.ang_blocks.shape[0] + 1
    want = gen.results(gen.run())
    scale = float(np.abs(want.log_prob).max())
    assert float(np.abs(got.log_prob - want.log_prob).max()) <= 1e-7 * scale
    for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("lattice", [True, False])
def test_raster_kernel_log_p_matches_the_jax_engine(dev, lattice):
    """G4 on the card, its lattice variant (and the generic variant beside
    it), in an engine whose comparison is the plain one, on the 32³ map of
    tests/test_torch_voxel_map.py, against the JAX engine's results on the
    raster path stored from the CPU (MAP32_JAX; JAX is not installed beside
    the card): log P within MAP_VS_JAX, the best orientation, CTF and
    displacement equal."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from tests.test_torch_voxel_map import BEST_FIELDS, MAP_VS_JAX, load_map32_jax

    inputs, want = load_map32_jax()
    cfg = RunConfig(projection="raster", use_kernels=False, kernel_projection=True,
                    autotune=False)
    eng = BioEMEngine(*inputs, cfg, device=dev, model_layout={"lattice": lattice})
    assert eng.fspec is None and (eng.lattice is not None) == lattice
    before = P.raster_project.launches
    got = eng.results(eng.run())
    assert P.raster_project.launches - before == eng.ang_blocks.shape[0]
    np.testing.assert_allclose(got.log_prob, want["log_prob"], **MAP_VS_JAX)
    for f in BEST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), want[f], err_msg=f)


@pytest.mark.parametrize("box,stride", [(32, 1), (224, 288)])
def test_bounds_census_on_card(dev, box, stride):
    """The card's census (ops/project_cuda.bounds_census through
    core.projection.oob_census, one launch) against projection_oob_report
    on a map whose corners leave the frame (kernel_probe.check_census: 32³
    at 64 orientations, 224³ at 16 of the reference grid's): the totals
    equal but for pairs at a snap's tie, the orientations affected and
    refused equal."""
    from bioem_tpu_torch.tools.kernel_probe import check_census

    before = P.bounds_census.launches
    c = check_census(dev, box, stride)
    assert P.bounds_census.launches == before + 1
    assert c["host"][0] > 0 and c["card"][1:] == c["host"][1:], c
    assert abs(c["card"][0] - c["host"][0]) <= c["ties"], c


def test_raster_counted_per_replay(rng, dev):
    """On the raster kernel branch each replay of the captured block step
    launches G4 once and neither G3 nor K2."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine

    eng = BioEMEngine(*_engine_problem(rng), RunConfig(orient_block=3, projection="raster"),
                      device=dev)
    nblk = eng.ang_blocks.shape[0]
    fns = (P.raster_project, P.project_prologue, P.fourier_project_block)
    before = [fn.launches for fn in fns]
    eng.run()
    assert [fn.launches - b for fn, b in zip(fns, before)] == [nblk + 1, 0, 0]


def test_ranking_mixed_radii_captures_once(rng, dev):
    """rank_models of a pair whose second model has a distinct radius per
    point (more than 32: the raster for both): one capture, G4 launched,
    and each model's per-image logP equal to its own raster engine on the
    same layout (rtol 1e-12, argmax tuples exact)."""
    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.core.engine import BioEMEngine
    from bioem_tpu_torch.io.model_io import Model
    from bioem_tpu_torch.rank import common_model_layout, rank_models

    p, orients, model, images = _engine_problem(rng)
    n = 40
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    dens = rng.uniform(40.0, 100.0, n).astype(np.float32)
    cont = Model(pts, np.linspace(1.0, 3.0, n).astype(np.float32), dens, float(dens.sum()))
    models = [model, cont]
    lay = common_model_layout(p, models)
    assert lay["force_raster"]
    cfg = RunConfig(orient_block=3)
    before = P.raster_project.launches
    _total, per_image, perf = rank_models(p, orients, models, images, cfg, device=dev)
    assert perf["captures"] == 1 and P.raster_project.launches > before
    for m, mod in enumerate(models):
        own = BioEMEngine(p, orients, mod, images, cfg, device=dev, model_layout=lay)
        assert own.fspec is None
        want = own.results(own.run())
        np.testing.assert_allclose(per_image[m], want.log_prob, rtol=1e-12, atol=0)
        for f in ("best_orient", "best_conv", "best_cent_x", "best_cent_y"):
            np.testing.assert_array_equal(getattr(perf["results"][m], f), getattr(want, f))
