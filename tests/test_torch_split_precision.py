"""The split-precision scheme of the port's tensor-core kernels, emulated on
the CPU, and the host logic of the K1 and K2 wrappers.

3xTF32 (csrc/compare_fused.cu K1, csrc/compare_batched.cu K4,
csrc/project.cu K2): each f32
operand is split x = hi + lo, hi = tf32(x), lo = tf32(x − hi) (round to
nearest, ties away, as ``cvt.rna.tf32.f32``); each k8 step forms
lo·hi + hi·lo + hi·hi. K1 and K4 form it in a zeroed accumulator, which is
added to the f32 sum with an IEEE add: the emulation takes the step's
products in f64 and rounds the step once to f32 (the tensor cores'
truncating in-step adds are what the per-step f32 add bounds). K2 chains
the steps of a 32-point chunk in one accumulator: the emulation truncates
after each of its products. Held against f64 at K1's stage-1 shape
(D = 21 and 35, N = 224) through stage 2 and the log-sum-exp, to
chip_smoke's limits: m rtol 1e-5 and se rtol 1.5e-4 from the plain f32
version, the log-sum-exp within 4× the plain version's distance from f64
(+1e-6); K1's stage 2 as the tensor cores run it at the wide chunks (D =
81 and 121: per m-tile [t1_re, t1_im]·[wy_re, −wy_im]ᵀ in 3xTF32 k8
steps) to the card tests' limits there, which a 1xTF32 stage 2 fails;
and at K2's group product (the separable Exᵀ·diag(d)·Ey of
80-, 36- and 1-point groups at N = 224), to 5e-5 of max|spectrum|.

Host logic, against the JAX package run as its own tests run it (Pallas in
interpret mode): K2's per-group point counts (core.projection's
FourierProjectionSpec.group_counts and the plain version that honours them) and K1's tiling rule
(ops/compare_cuda.k1_plan), whose reach must cover every shape the earlier
FP32 FMA K1 took; the plain K1 at the wide and many-fold shapes the new kernel serves.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bioem_tpu.core.posterior import displacement_dft_weights
from bioem_tpu.ops.compare_pallas import fused_compare_block as j_compare
from bioem_tpu.ops.project_pallas import fourier_project_block as j_project_block
from bioem_tpu_torch.core import projection as TP
from bioem_tpu_torch.core.orientations import rotation_matrices
from bioem_tpu_torch.ops import compare_cuda as C
from bioem_tpu_torch.ops import project_cuda as P

from .conftest import tiny_model, tiny_params

F64 = torch.float64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (10 mantissa bits), round to nearest with ties away from
    zero, on the bit pattern (sign-magnitude: adding half a TF32 ulp to the
    magnitude rounds either sign away from zero)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def gemm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (R, K) · b (K, S), K a multiple of 8, in the kernels' 3xTF32 steps."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        step = (al[:, s].double() @ bh[s].double() + ah[:, s].double() @ bl[s].double()
                + ah[:, s].double() @ bh[s].double())
        out = out + step.float()
    return out


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 → f32 rounded toward zero, as the tensor cores' accumulator adds."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def gemm_3xtf32_chained(a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """a (R, K) · b (K, S), K a multiple of 8, as K2 runs it: runs of
    ``chain`` k8 steps accumulate in one tensor-core accumulator, each of a
    step's three products added exactly and the sum truncated to f32; each
    run's accumulator is then added to the f32 sum."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8 * chain):
        acc = torch.zeros_like(out)
        for k in range(k0, min(a.shape[1], k0 + 8 * chain), 8):
            s = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = round_toward_zero(acc.double() + x[:, s].double() @ y[s].double())
        out = out + acc
    return out


def test_tf32_rounding():
    """Ties go away from zero, below half an ulp rounds down, hi + lo holds
    x to ~2⁻²² relative."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12, -(one + 2.0 ** -11), 3.0,
                      one + 3 * 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, one, -(one + 2.0 ** -10), 3.0, one + 2.0 ** -10],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.as_tensor(np.random.default_rng(0).normal(0, 1, 10_000).astype(np.float32))
    hi, lo = split(y)
    rel = ((hi.double() + lo.double() - y.double()).abs() / y.double().abs()).max()
    assert float(rel) < 2.0 ** -21


def test_round_toward_zero():
    """Either sign goes toward zero; values f32 holds stay."""
    x = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -40, -(1 - 2.0 ** -40), 3.0],
                     dtype=F64)
    want = torch.tensor([1.0, -1.0, 1 - 2.0 ** -24, -(1 - 2.0 ** -24), 3.0], dtype=torch.float32)
    assert torch.equal(round_toward_zero(x), want)


def _k1_problem(rng, d, n_fold, n=224, n_img=2):
    """One orientation·ctf's conv and two images at N = 224 with the true
    lattice DFT weights (displacements multiples of n_fold), production-like
    a_u, b_u (kernel_probe.production_block_inputs' scales)."""
    f, m = n // 2 + 1, n // n_fold
    disp = ((np.arange(d) - d // 2) * n_fold).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    r = lambda *s: torch.as_tensor(rng.normal(0, 1, s).astype(np.float32))  # noqa: E731
    g = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))  # noqa: E731
    return dict(conv_re=r(1, n, f), conv_im=r(1, n, f), img_re=r(n_img, n, f),
                img_im=r(n_img, n, f), wx_re=g(wx.real[:, :m]), wx_im=g(wx.imag[:, :m]),
                wy_re=g(wy.real), wy_im=g(wy.imag),
                a_u=g(np.abs(rng.normal(0, 1e-6, (1, n_img)))),
                b_u=g(np.abs(rng.normal(0, 1e-9, (1, n_img)))), a_coef=(3.0 - n * n) / 2)


def _stage2(t1r, t1i, wy_re, wy_im, scheme):
    """cc (D, D) = Re(t1·wyᵀ) from t1 (D, F): "f32" as the CUDA cores run
    it (chunks of ≤ 32 rows); "3xtf32" as the tensor cores run it at the
    wide chunks: per m-tile of 64 frequencies the product [t1_re, t1_im] ·
    [wy_re, −wy_im]ᵀ in 3xTF32 k8 steps, re half then im half (each half
    padded to whole steps), each step added to the m-tile's f32 sum, the
    m-tiles' sums added in order; "1xtf32" the same product with TF32
    operands (hi·hi alone), the control a tolerance must reject."""
    if scheme == "f32":
        return t1r @ wy_re.T - t1i @ wy_im.T
    cc = torch.zeros(t1r.shape[0], wy_re.shape[0], dtype=torch.float32)
    for f0 in range(0, t1r.shape[1], 64):
        fs = slice(f0, f0 + 64)
        nf = t1r[:, fs].shape[1]
        pad = -(-nf // 8) * 8 - nf
        z = lambda t: torch.cat([t, t.new_zeros(t.shape[0], pad)], 1)  # noqa: E731
        a = torch.cat([z(t1r[:, fs]), z(t1i[:, fs])], 1)
        b = torch.cat([z(wy_re[:, fs]), z(-wy_im[:, fs])], 1).T.contiguous()
        if scheme == "3xtf32":
            cc = cc + gemm_3xtf32(a, b)
        else:
            cc = cc + (tf32(a).double() @ tf32(b).double()).float()
    return cc


def _emulated_k1_cc(x, n_fold, stage2="f32"):
    """K1's cc lattice with stage 1 in emulated 3xTF32: the GEMM t1ᵀ = pᵀ·Wᵀ
    with W = [[wx_re, −wx_im], [wx_im, wx_re]], K ordered as the kernel's k8
    steps (four folded rows' real parts, then their imaginary parts);
    stage 2 in ``stage2`` (:func:`_stage2`)."""
    d, m = x["wx_re"].shape
    mp = -(-m // 4) * 4
    cr, ci = x["conv_re"][0], x["conv_im"][0]
    out = []
    for i in range(x["img_re"].shape[0]):
        ir, ii = x["img_re"][i], x["img_im"][i]
        pr = C._fold(cr * ir - ci * ii, n_fold, m)  # (M, F), f32 as the kernel forms it
        pi = C._fold(cr * ii + ci * ir, n_fold, m)
        pad = lambda t: torch.cat([t, t.new_zeros(mp - m, *t.shape[1:])])  # noqa: E731
        pr, pi = pad(pr), pad(pi)
        a = torch.stack([pr.reshape(mp // 4, 4, -1), pi.reshape(mp // 4, 4, -1)], 1)
        a = a.reshape(2 * mp, -1).T.contiguous()  # (F, 2M) in step order
        wr = torch.cat([x["wx_re"], x["wx_re"].new_zeros(d, mp - m)], 1)
        wi = torch.cat([x["wx_im"], x["wx_im"].new_zeros(d, mp - m)], 1)

        def k_order(re_part, im_part):  # (d, M) pair → (d, 2M) in step order
            t = torch.stack([re_part.reshape(d, mp // 4, 4), im_part.reshape(d, mp // 4, 4)], 2)
            return t.reshape(d, 2 * mp)

        w = torch.cat([k_order(wr, -wi), k_order(wi, wr)])  # (2D, 2M): rows re, then im
        t1 = gemm_3xtf32(a, w.T.contiguous())  # (F, 2D)
        t1r, t1i = t1[:, :d].T, t1[:, d:].T  # (D, F)
        out.append(_stage2(t1r, t1i, x["wy_re"], x["wy_im"], stage2))
    return torch.stack(out)[None]  # (1, I, D, D)


def _lse(cc, a_u, b_u, a_coef):
    v = a_coef * torch.log1p(a_u[..., None] * cc.flatten(2) - b_u[..., None] * cc.flatten(2) ** 2)
    m = v.amax(-1)
    return m, torch.exp(v - m[..., None]).sum(-1)


@pytest.mark.parametrize("d,n_fold", [(21, 2), (35, 1)])
def test_3xtf32_k1_stage1_meets_chip_smoke_limits(rng, d, n_fold):
    x = _k1_problem(rng, d, n_fold)
    args = [x[k] for k in ("conv_re", "conv_im", "img_re", "img_im", "wx_re", "wx_im",
                           "wy_re", "wy_im")]
    plain_cc = C.displacement_cc_plain(*args, n_fold=n_fold)
    cc64 = C.displacement_cc_plain(*(t.double() for t in args), n_fold=n_fold)
    emu_cc = _emulated_k1_cc(x, n_fold)
    scale = float(cc64.abs().max())
    assert float((emu_cc.double() - cc64).abs().max()) < 5e-6 * scale
    au, bu, a = x["a_u"], x["b_u"], x["a_coef"]
    em, es = _lse(emu_cc, au, bu, a)
    pm, ps = _lse(plain_cc, au, bu, a)
    m64, s64 = _lse(cc64, au.double(), bu.double(), a)
    assert torch.all(torch.isfinite(em)) and float(m64.abs().min()) > 1.0
    assert float(((em - pm).abs() / pm.abs()).max()) <= 1e-5
    assert float(((es - ps).abs() / ps).max()) <= 1.5e-4
    lse64 = m64 + s64.log()
    e_lse = float((em.double() + es.double().log() - lse64).abs().max())
    p_lse = float((pm.double() + ps.double().log() - lse64).abs().max())
    assert e_lse <= 4 * p_lse + 1e-6


@pytest.mark.parametrize("d", [81, 121])
@pytest.mark.parametrize("stage2", ["3xtf32", "1xtf32"])
def test_k1_stage2_on_the_tensor_cores_meets_the_card_tests_limits(rng, d, stage2):
    """Stage 2 as K1 runs it at the wide chunks (D = 81: one chunk of 88
    rows; D = 121: two of 64), in emulated 3xTF32 after the emulated 3xTF32
    stage 1, meets the limits tests/test_torch_cuda.py holds K1 and K3 to
    there, and stage 2 in 1xTF32 fails every one of them: cc within 5e-6 of
    max|cc| of f64 (the plain f32 version reads ~4e-7, 3xTF32 ~3e-7, 1xTF32
    ~3e-4); m within rtol 1e-5 of the plain f32 version (3xTF32 ~5e-7,
    1xTF32 3–4e-4: a_coef = −25,088 amplifies δcc); the log-sum-exp within
    twice the plain version's distance from f64 (3xTF32 ~0.5×, 1xTF32
    ~300×, 0.16–0.34 in log P)."""
    x = _k1_problem(rng, d, 1)
    args = [x[k] for k in ("conv_re", "conv_im", "img_re", "img_im", "wx_re", "wx_im",
                           "wy_re", "wy_im")]
    plain_cc = C.displacement_cc_plain(*args)
    cc64 = C.displacement_cc_plain(*(t.double() for t in args))
    emu_cc = _emulated_k1_cc(x, 1, stage2=stage2)
    au, bu, a = x["a_u"], x["b_u"], x["a_coef"]
    em, es = _lse(emu_cc, au, bu, a)
    pm, ps = _lse(plain_cc, au, bu, a)
    m64, s64 = _lse(cc64, au.double(), bu.double(), a)
    lse64 = m64 + s64.log()
    checks = {
        "cc": float((emu_cc.double() - cc64).abs().max()) < 5e-6 * float(cc64.abs().max()),
        "m": float(((em - pm).abs() / pm.abs()).max()) <= 1e-5,
        "lse": (float((em.double() + es.double().log() - lse64).abs().max())
                <= 2 * float((pm.double() + ps.double().log() - lse64).abs().max())),
    }
    assert all(checks.values()) if stage2 == "3xtf32" else not any(checks.values()), checks


@pytest.mark.parametrize("scheme", ["3xtf32", "fma"])
def test_k2_group_product_meets_chip_smoke_limit(rng, scheme):
    """K2's Σ_g Ŝ_g ⊙ (Exᵀ·diag(d)·Ey) at N = 224 for groups of 80, 36 and 1
    points: in emulated 3xTF32 steps in the kernel's K order (each k8 step
    four points' Re X, then their Im X; a group padded to a multiple of
    four points), chained eight steps (a chunk of 32 points) in a
    truncating accumulator, and in plain f32 (as the FMA tiles ran it),
    each within 5e-5 of max|spectrum| of f64."""
    n = 224
    f = n // 2 + 1
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    k1, k2 = np.arange(n), np.arange(f)
    out = np.zeros((n, f), np.complex128)
    got = torch.zeros(n, 2 * f, dtype=torch.float32)
    for pts in (80, 36, 1):
        a = rng.integers(0, n, pts)
        b = rng.integers(0, n, pts)
        dens = rng.uniform(0.5, 2.0, pts)
        ex = tw[np.outer(a, k1) % n].astype(np.complex64)  # (P, N): the kernel's f32 tables
        ey = tw[np.outer(b, k2) % n].astype(np.complex64)  # (P, F)
        dx = (dens.astype(np.float32)[:, None] * ex).astype(np.complex64)
        st = (rng.normal(0, 1, (n, f)) + 1j * rng.normal(0, 1, (n, f))).astype(np.complex64)
        out += st * (dx.astype(np.complex128).T @ ey.astype(np.complex128))
        lhs = torch.as_tensor(np.concatenate([dx.real.T, dx.imag.T], 1))  # (N, 2P)
        rhs = torch.as_tensor(np.block([[ey.real, ey.imag], [-ey.imag, ey.real]]))  # (2P, 2F)
        if scheme == "3xtf32":
            pp = -(-pts // 4) * 4

            def steps(re_part, im_part, dim):  # (…, P) pair → (…, 2Pp) in step order
                pad = lambda t: torch.cat([t, t.new_zeros(*t.shape[:dim], pp - pts, *t.shape[dim + 1:])], dim)  # noqa: E731
                r4, i4 = (pad(t).unflatten(dim, (pp // 4, 4)) for t in (re_part, im_part))
                return torch.stack([r4, i4], dim + 1).flatten(dim, dim + 2)

            s = gemm_3xtf32_chained(steps(lhs[:, :pts], lhs[:, pts:], 1),
                                    steps(rhs[:pts], rhs[pts:], 0), chain=8)
        else:
            s = lhs @ rhs
        sr, si = s[:, :f], s[:, f:]
        str_, sti = torch.as_tensor(st.real), torch.as_tensor(st.imag)
        got = got + torch.cat([str_ * sr - sti * si, str_ * si + sti * sr], 1)
    ref = np.concatenate([out.real, out.imag], 1)
    err = np.abs(got.numpy().astype(np.float64) - ref).max()
    assert err < 5e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# K2's per-group point counts
# ---------------------------------------------------------------------------

def test_group_counts_from_the_spec(rng):
    """The spec's group_counts are the model points per radius group, the
    leading ones of each group's pad-mask row; the kernel's tensor of them
    is made once per spec and device."""
    p = tiny_params()
    model = tiny_model(rng, n_points=20)
    spec, gidx, pmask, _st, _sums = TP.make_fourier_projection_spec(p, model.radii)
    counts = spec.group_counts
    uniq, n_per = np.unique(model.radii, return_counts=True)
    assert list(counts) == n_per.tolist()
    assert sum(counts) == model.radii.size and spec.group_pad % 8 == 0
    mask = pmask.reshape(spec.n_groups, spec.group_pad)
    for g, k in enumerate(counts):
        assert mask[g, :k].all() and not mask[g, k:].any()
        np.testing.assert_array_equal(model.radii[gidx[g * spec.group_pad: g * spec.group_pad + k]],
                                      uniq[g])
    t = P.counts_tensor(counts, torch.device("cpu"))
    assert t.dtype == torch.int32 and t.tolist() == list(counts)
    assert P.counts_tensor(counts, torch.device("cpu")) is t


def _spec_inputs(rng, n_orient=3):
    """A 20-point model in three radius groups (padded to 8 slots each)."""
    p = tiny_params()
    model = tiny_model(rng, n_points=20)
    model = dataclasses.replace(model, radii=rng.choice(np.float32([1.2, 2.0, 3.0]), 20))
    spec, gidx, pmask, st, _sums = TP.make_fourier_projection_spec(p, model.radii)
    q = rng.normal(0, 1, (n_orient, 4))
    rot = rotation_matrices(torch.as_tensor((q / np.linalg.norm(q, axis=1, keepdims=True))
                                            .astype(np.float32)), True)
    i0, j0, de = TP.grouped_snap(spec, rot, torch.as_tensor(model.points[gidx]),
                                 torch.as_tensor(model.radii[gidx]),
                                 torch.as_tensor(model.densities[gidx] * pmask))
    counts = torch.tensor(spec.group_counts, dtype=torch.int32)
    return spec, i0, j0, de, counts, st


def _jax_project(spec, i0, j0, de, st):
    th = lambda x: jnp.asarray(-np.float32(2 * math.pi / spec.n_pixels) * x.numpy().astype(np.float32))  # noqa: E731
    r = j_project_block(th(i0), th(j0), jnp.asarray(de.numpy()),
                        jnp.asarray(np.ascontiguousarray(st.real)),
                        jnp.asarray(np.ascontiguousarray(st.imag)),
                        n=spec.n_pixels, interpret=True)
    return np.asarray(r[0]), np.asarray(r[1])


def test_project_with_counts_vs_pallas(rng):
    """The plain K2 given the spec's per-group counts (what the kernel reads)
    equals the JAX kernel over every slot (the padding's density is zero),
    within 5e-5 of max|spectrum| (tests/test_torch_projection.py's bound)."""
    spec, i0, j0, de, counts, st = _spec_inputs(rng)
    jr, ji = _jax_project(spec, i0, j0, de, st)
    tr, ti = P.fourier_project_block(i0, j0, de, torch.as_tensor(np.ascontiguousarray(st.real)),
                                     torch.as_tensor(np.ascontiguousarray(st.imag)),
                                     n=spec.n_pixels, counts=counts)
    assert P.fourier_project_block.launches == 0  # CPU tensors: plain version
    scale = max(np.abs(jr).max(), np.abs(ji).max())
    assert np.abs(tr.numpy() - jr).max() < 5e-5 * scale
    assert np.abs(ti.numpy() - ji).max() < 5e-5 * scale


def test_project_counts_skip_the_slots_after_them(rng):
    """Counts below a group's points: the plain version skips the slots
    after them even where their density is not zero, as the kernel does;
    the JAX kernel with those densities zeroed agrees (5e-5 of max)."""
    spec, i0, j0, de, counts, st = _spec_inputs(rng)
    short = counts // 2
    de_cut = de.clone()
    for g, k in enumerate(short.tolist()):
        de_cut[g, :, k:] = 0.0
    jr, ji = _jax_project(spec, i0, j0, de_cut, st)
    st_re = torch.as_tensor(np.ascontiguousarray(st.real))
    st_im = torch.as_tensor(np.ascontiguousarray(st.imag))
    tr, ti = P.fourier_project_block(i0, j0, de, st_re, st_im, n=spec.n_pixels, counts=short)
    scale = max(np.abs(jr).max(), np.abs(ji).max())
    assert np.abs(tr.numpy() - jr).max() < 5e-5 * scale
    assert np.abs(ti.numpy() - ji).max() < 5e-5 * scale
    fr, _ = P.fourier_project_block(i0, j0, de, st_re, st_im, n=spec.n_pixels, counts=counts)
    assert float((fr - tr).abs().max()) > 1e-3 * scale  # the cut slots did count before


def test_project_kernel_has_no_two_n_squared_rule():
    """The kernel's limit is its twiddle table in shared memory (N ≤ 4352;
    the table index a·(k mod N) < N² fits int32 there), where the earlier
    2·N² ≤ 2^24 rule stopped at N = 2896."""
    assert P.MAX_N == 4352 and P.MAX_N ** 2 < 2 ** 31
    assert 8 * P.MAX_N + 4 * 49408 <= 227 * 1024 < 8 * (P.MAX_N + 1) + 4 * 49408
    assert 2 * 4096 ** 2 > 1 << 24 and 4096 <= P.MAX_N


# ---------------------------------------------------------------------------
# K1's tiling and reach
# ---------------------------------------------------------------------------

def _fma_k1_smem(d, m, f):
    """The earlier FP32 FMA K1's and K3's shared memory (their
    smem_bytes): wx resident, wy and t1, two D² arrays."""
    dc = 8 if d <= 8 else (16 if d <= 16 else 24)
    dpad = -(-d // dc) * dc
    return 8 * (m * dpad + 2 * d * f) + 8 * d * d


def test_k1_plan_at_production():
    """The production block (D = 21, M = 112, F = 113, two folds) runs four
    warpgroups (one image each) and K chunks of eight steps."""
    n_wg, kc, smem = C.k1_plan(21, 112, 113, 2)
    assert (n_wg, kc) == (4, 8) and smem == C.k1_smem_bytes(21, 112, 113, 2, 4, 8) <= C.MAX_SMEM
    # W (hi, lo: 2 × 48 rows × 8 steps × 32 B) and conv (8 steps × 2 folds × 4
    # rows × 68 × 8 B) double-buffered, the four t1 tiles (64 × 52 floats,
    # 53248 B) over them, one m-tile of wy (64 × 21 complex) and the four
    # lattice chunks (24 × 21 floats: one chunk holds the lattice), each
    # rounded up to 128 bytes
    assert smem == 2 * 24576 + 2 * 34816 + 10752 + 8064


@pytest.mark.parametrize("n_fold", [1, 2])
@pytest.mark.parametrize("d", [21, 81, 121])
def test_k1_last_plan_and_bytes(d, n_fold):
    """What fused_compare_block.last_plan reports at N = 224 (the production
    block's D = 21, the reference grid's D = 81, the wide grid's D = 121):
    the plan's warpgroups and K-chunk steps, and the 32-row parts of the
    lattice that read each formed p: 1 at D = 21 (four warpgroups, one
    chunk of 24 rows), 3 at D = 81 (two warpgroups, one chunk of 88 rows),
    2 at D = 121 (two warpgroups, two chunks of 64); the plan's bytes are
    k1_smem_bytes of its tiling and fit a block beside the static slots."""
    m = 224 // n_fold
    n_wg, kc, smem = C.k1_plan(d, m, 113, n_fold)
    kc_wide = 8 if n_fold == 1 else 4  # fold 2 doubles the conv rows a K chunk
    want = {21: (4, 8, 1), 81: (2, kc_wide, 3), 121: (2, kc_wide, 2)}[d]
    assert C.k1_last_plan(d, m, 113, n_fold) == (n_wg, kc, C.k1_chunks_per_p(d, n_wg)) == want
    assert C.k1_rows(d, n_wg) == {21: (1, 24), 81: (1, 88), 121: (2, 64)}[d]
    assert smem == C.k1_smem_bytes(d, m, 113, n_fold, n_wg, kc)
    assert smem + C.K1_STATIC_SMEM <= C.MAX_SMEM


@pytest.mark.parametrize("d", [33, 35, 63, 65, 81, 87, 89, 107, 121, 127])
def test_k1_wide_chunks_take_33_to_128_rows(d):
    """Two warpgroups take a padded lattice of 33 to 128 rows in wide
    chunks (one of 64 or 88 rows, else two of 64: NP = 128 or 176), and
    k1_plan picks them first at N = 224, folds 1 and 2; each chunk holds at
    least one lattice row, and every 32-row part of a chunk reads its p.
    Four warpgroups keep chunks of at most 32 rows."""
    n_nc, dc = C.k1_rows(d, 2)
    assert dc in (64, 88) and (n_nc - 1) * dc < d <= n_nc * dc
    assert n_nc == (1 if d <= 88 else 2)
    assert C.k1_chunks_per_p(d, 2) == -(-dc // 32) and C.k1_chunks_per_p(d, 4) == 1
    assert C.k1_rows(d, 4)[1] <= 32
    for n_fold in (1, 2):
        n_wg, kc, smem = C.k1_plan(d, 224 // n_fold, 113, n_fold)
        assert n_wg == 2 and smem == C.k1_smem_bytes(d, 224 // n_fold, 113, n_fold, 2, kc)


def test_k1_tilings_it_has():
    """k1_smem_bytes is 0 for a tiling K1 has not (the C formula's `valid`):
    two warpgroups below 33 padded rows, where four always fit; other
    warpgroup counts and K chunks. Past 128 padded rows two warpgroups take
    32-row chunks again, after four run out at D = 159; the reach ends at
    D = 257."""
    assert C.k1_smem_bytes(21, 112, 113, 2, 2, 8) == 0
    assert C.k1_smem_bytes(32, 112, 113, 2, 2, 1) == 0
    assert C.k1_smem_bytes(33, 112, 113, 2, 2, 1) > 0
    assert C.k1_smem_bytes(81, 224, 113, 1, 3, 4) == 0
    assert C.k1_smem_bytes(81, 224, 113, 1, 2, 3) == 0
    for d in range(1, 33):
        assert C.k1_plan(d, 224, 113, 1)[0] == 4
    assert C.k1_rows(129, 2) == (5, 32) and C.k1_plan(129, 224, 113, 1)[0] == 4
    for n_fold in (1, 2):
        m = 224 // n_fold
        assert C.k1_plan(157, m, 113, n_fold)[0] == 4 and C.k1_plan(159, m, 113, n_fold)[0] == 2
        assert C.k1_plan(257, m, 113, n_fold) is not None
        assert C.k1_plan(259, m, 113, n_fold) is None


@pytest.mark.parametrize("n_fold", [1, 2, 3, 4])
def test_k1_reach_covers_the_fma_kernel(n_fold):
    """Every (D, M, F) the earlier FP32 FMA K1 took at this fold count has a
    K1 tiling,
    the wide lattices (D up to 61) and M = 224 at D = 21 included."""
    taken = 0
    for d in list(range(1, 40)) + [45, 61, 64, 90]:
        for m in (4, 15, 16, 24, 48, 56, 112, 224, 448):
            for f in (8, 9, 17, 33, 41, 57, 113, 225):
                if _fma_k1_smem(d, m, f) <= C.MAX_SMEM:
                    taken += 1
                    assert C.k1_plan(d, m, f, n_fold) is not None, (d, m, f, n_fold)
    assert taken > 2000
    for d, m, f in ((35, 48, 25), (61, 64, 33), (21, 224, 113)):
        assert C.k1_plan(d, m, f, n_fold) is not None


@pytest.mark.parametrize("n_fold", [1, 2])
def test_k1_plan_reaches_every_lattice_to_d129(n_fold):
    """K1 (and K3, which launches with its plan) tiles every odd lattice
    3 ≤ D ≤ min(129, N/n_fold − 1) at every even N from 64 to 512: 129 is
    ±64 at stride 1, a quarter of a 512-pixel box each way. The bytes fit a
    block beside the kernel's static slots and do not change with F (or M)
    at fixed D: the lattice is held one row chunk at a time and wy one
    m-tile at a time. Every row chunk holds at least one row of the
    lattice (the kernel reduces each chunk without checking), with four
    warpgroups and with two."""
    for d in range(3, 260, 2):
        for n_wg in (2, 4):
            n_nc, dc = C.k1_rows(d, n_wg)
            assert (n_nc - 1) * dc < d <= n_nc * dc, (d, n_wg)
    tiled = 0
    for n in range(64, 513, 2):
        m, f = n // n_fold, n // 2 + 1
        for d in range(3, min(129, m - 1) + 1, 2):
            plan = C.k1_plan(d, m, f, n_fold)
            assert plan is not None, (n, n_fold, d)
            n_wg, kc, smem = plan
            assert smem + C.K1_STATIC_SMEM <= C.MAX_SMEM
            assert smem == C.k1_smem_bytes(d, m, f, n_fold, n_wg, kc)
            for f2, m2 in ((8, 4), (257, 512), (1025, 2048)):
                assert C.k1_smem_bytes(d, m2, f2, n_fold, n_wg, kc) == smem, (n, d, f2)
            tiled += 1
    assert tiled == sum(len(range(3, min(129, n // n_fold - 1) + 1, 2))
                        for n in range(64, 513, 2))


@pytest.mark.parametrize("n_disp,n_fold,n", [(35, 1, 48), (9, 3, 48), (9, 4, 64)])
def test_k1_plain_at_wide_and_folded_shapes_vs_pallas(rng, n_disp, n_fold, n):
    """The plain K1 (what the card's K1 is held to) against the JAX kernel
    in interpret mode at the shapes only the new K1 serves on the card
    (D > 32) and at folds 3 and 4: m, se rtol 1e-5, the argmax equal away
    from near-ties (tests/test_torch_compare.py's rule)."""
    f, m = n // 2 + 1, n // n_fold
    disp = ((np.arange(n_disp) - n_disp // 2) * n_fold).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    args = (r(2, n, f), r(2, n, f), r(1, n, f), r(1, n, f), r(2, n, f), r(2, n, f),
            np.ascontiguousarray(wx.real[:, :m]), np.ascontiguousarray(wx.imag[:, :m]),
            wy.real.copy(), wy.imag.copy(),
            np.abs(rng.normal(0, 1e-5, (2, 2))).astype(np.float32),
            np.abs(rng.normal(0, 1e-8, (2, 2))).astype(np.float32))
    a_coef = (3.0 - n * n) / 2
    ref = j_compare(*(jnp.asarray(x) for x in args), a_coef=a_coef, img_tile=2, n_fold=n_fold,
                    interpret=True, mxu_mode="highest")
    got = C.fused_compare_block(*(torch.as_tensor(x) for x in args), a_coef=a_coef,
                                n_fold=n_fold)
    (rm, rs, rd, _rc), (gm, gs, gd, _gc) = [np.asarray(x) for x in ref], [x.numpy() for x in got]
    np.testing.assert_allclose(gm, rm, rtol=1e-5)
    np.testing.assert_allclose(gs, rs, rtol=1e-5)
    t = [torch.as_tensor(x) for x in args]
    conv_re = (t[0][:, None] * t[2][None] + t[1][:, None] * t[3][None]).reshape(2, n, f)
    conv_im = (t[1][:, None] * t[2][None] - t[0][:, None] * t[3][None]).reshape(2, n, f)
    cc = C.displacement_cc_plain(conv_re, conv_im, *t[4:10], n_fold=n_fold).flatten(2)
    v = a_coef * torch.log1p(t[10][..., None] * cc - t[11][..., None] * cc * cc)
    top2 = torch.topk(v, 2, dim=-1).values
    tie = ((top2[..., 0] - top2[..., 1]) <= 1e-5 * abs(a_coef)).numpy()
    assert tie.sum() <= 1
    np.testing.assert_array_equal(gd[~tie], rd[~tie])


# ---------------------------------------------------------------------------
# K3: K1's kernel in its cc-out body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fold", [1, 2, 3, 4])
def test_k3_plan_takes_every_shape_k1_plan_takes(n_fold):
    """K3 launches with K1's tiling (compare_cuda.launch_plan): every
    (D, M, F) k1_plan tiles, K3 takes with the same plan, and it refuses
    the rest before any launch. D = 61 at M = 224 (a stride-1 ±30 lattice
    at N = 224), which the earlier FP32 FMA K3 refused, is taken."""
    tiled = 0
    for d in list(range(1, 40)) + [45, 61, 64, 90]:
        for m in (4, 15, 16, 24, 48, 56, 112, 224, 448):
            for f in (8, 9, 17, 33, 41, 57, 113, 225):
                plan = C.k1_plan(d, m, f, n_fold)
                if plan is None:
                    with pytest.raises(ValueError, match="no K1 tiling fits"):
                        C.launch_plan("fused_displacement_cc", d, m, f, m * n_fold, n_fold, 64)
                    continue
                tiled += 1
                assert C.launch_plan("fused_displacement_cc", d, m, f, m * n_fold, n_fold,
                                     64) == plan
    assert tiled > 2000
    assert _fma_k1_smem(61, 224, 113) > C.MAX_SMEM
    n_wg, kc, smem = C.launch_plan("fused_displacement_cc", 61, 224, 113, 224 * n_fold,
                                   n_fold, 64)
    assert smem <= C.MAX_SMEM and (n_wg, kc) == C.k1_plan(61, 224, 113, n_fold)[:2]


@pytest.mark.parametrize("d,n_fold,n", [(21, 2, 224), (5, 1, 15)])
def test_3xtf32_k3_lattice_within_5e_5_of_f64(rng, d, n_fold, n):
    """K3's lattice is K1's cc before the log-sum-exp: in emulated 3xTF32
    (stage 1 in the kernel's k8 steps) it is within chip_smoke's 5e-5 of
    max|cc| of the f64 lattice at the production shape and at N = 15; the
    plain f32 version is too."""
    x = _k1_problem(rng, d, n_fold, n=n, n_img=3)
    args = [x[k] for k in ("conv_re", "conv_im", "img_re", "img_im", "wx_re", "wx_im",
                           "wy_re", "wy_im")]
    cc64 = C.displacement_cc_plain(*(t.double() for t in args), n_fold=n_fold)
    scale = float(cc64.abs().max())
    emu = _emulated_k1_cc(x, n_fold)
    assert emu.shape == cc64.shape == (1, 3, d, d)
    assert float((emu.double() - cc64).abs().max()) < 5e-5 * scale
    plain = C.displacement_cc_plain(*args, n_fold=n_fold)
    assert float((plain.double() - cc64).abs().max()) < 5e-5 * scale
