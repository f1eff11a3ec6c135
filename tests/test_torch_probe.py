"""The kernel probes P1–P3 (``ops/probe_cuda.py``,
``bioem_tpu_torch.tools.kernel_probe``) on the CPU: the plain versions
against NumPy in f64 and P1's against the JAX probe's Pallas kernel (in
interpret mode), P1's 3xTF32 and 1xTF32 steps emulated on the CPU, the
wrappers taking their plain versions on CPU tensors, P1's bounds, and the
probe tools refusing to run without a card. The kernels themselves run in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from bioem_tpu_torch.ops import compare_cuda as C
from bioem_tpu_torch.ops import probe_cuda as P
from bioem_tpu_torch.tools import kernel_probe

from .test_torch_split_precision import gemm_3xtf32_chained, round_toward_zero, tf32

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _p1_inputs():
    """The TPU probe's P1 inputs (tools/kernel_probe.py:41-44)."""
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (96, 112)).astype(np.float32),
            rng.normal(0, 1, (112, 113)).astype(np.float32))


def _p2_inputs(n_img=64):
    """The TPU probe's P2 shapes and data, in bf16 (tools/kernel_probe.py:83-86)."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(0, 1, (96, 112)).astype(np.float32)).to(torch.bfloat16)
    b = torch.as_tensor(rng.normal(0, 1, (n_img, 112, 128)).astype(np.float32)).to(torch.bfloat16)
    return a, b


def test_f32_product_plain_is_f64_rounded_once():
    """P1's plain version is the f64 product rounded to f32 once: equal to
    NumPy's f64 product cast to f32, element for element."""
    a, b = _p1_inputs()
    want = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)
    got = P.f32_product_plain(torch.as_tensor(a), torch.as_tensor(b), batch=3)
    assert got.shape == (3, 96, 113) and got.dtype == torch.float32
    for z in range(3):
        np.testing.assert_array_equal(got[z].numpy(), want)


@pytest.mark.parametrize("scheme", P.SCHEMES)
def test_f32_product_cpu_takes_plain(scheme):
    a, b = (torch.as_tensor(x) for x in _p1_inputs())
    torch.testing.assert_close(P.f32_product(a, b, scheme=scheme, batch=2),
                               P.f32_product_plain(a, b, 2), rtol=0, atol=0)


def test_f32_product_rejects_unknown_scheme():
    a, b = (torch.as_tensor(x) for x in _p1_inputs())
    with pytest.raises(ValueError, match="scheme"):
        P.f32_product(a, b, scheme="bf16x6")


def _jax_probe_module():
    """tools/kernel_probe.py, the JAX probe (it imports JAX and Pallas)."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_probe", os.path.join(ROOT, "tools", "kernel_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_f32_product_plain_vs_jax_p1():
    """P1's plain version against the JAX P1 (tools/kernel_probe.py:
    _f32_dot_kernel through pl.pallas_call in interpret mode) on the TPU
    probe's inputs: median relative difference below 1e-6, max |Δ| ≤
    1e-5·max|C|."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    jp = _jax_probe_module()
    a, b = _p1_inputs()
    want = np.asarray(pl.pallas_call(
        jp._f32_dot_kernel, out_shape=jax.ShapeDtypeStruct((96, 113), jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    got = P.f32_product_plain(torch.as_tensor(a), torch.as_tensor(b))[0].numpy()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert np.median(rel) < 1e-6
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _tf32_chained_once(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (R, K) · b (K, S) in 1xTF32 as P1 runs it: both operands rounded to
    TF32, every k8 step added into one accumulator, each add truncated."""
    ah, bh = tf32(a), tf32(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = round_toward_zero(acc.double() + ah[:, s].double() @ bh[s].double())
    return acc


P1_EMULATED = [(48, 224, 1024), (96, 112, 113)]  # K4's stage 1, the TPU probe's shape


@pytest.mark.parametrize("shape", P1_EMULATED, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scheme", ["3xtf32", "tf32"])
def test_p1_tf32_steps_emulated(shape, scheme):
    """P1's TF32 schemes in the kernel's order (csrc/probe.cu), emulated:
    the kernel computes Cᵀ = Bᵀ·Aᵀ with B in registers and A in shared
    memory, both split by cvt.rna into TF32 hi (and lo). 3xTF32 forms each
    k8 step's b_lo·a_hi, b_hi·a_lo, b_hi·a_hi in a zeroed accumulator
    (each add truncated) and adds it to the f32 sum: within median
    relative error 1e-6 of f64. 1xTF32 chains every step through one
    accumulator: above 1e-5, the trap the probe shows."""
    m, k, n = shape
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32))
    b = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32))
    ref = a.double() @ b.double()
    if scheme == "3xtf32":
        got = gemm_3xtf32_chained(b.T.contiguous(), a.T.contiguous(), 1).T
    else:
        got = _tf32_chained_once(b.T.contiguous(), a.T.contiguous()).T
    med = float(((got.double() - ref).abs() / ref.abs().clamp_min(1e-30)).median())
    assert (med < 1e-6) if scheme == "3xtf32" else (med > 1e-5)


def _broken(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A faulty 1xTF32 product, as a kernel could get it wrong."""
    if name == "zeros":
        return torch.zeros(a.shape[0], b.shape[1])
    if name == "rows_swapped":  # the two 24-row halves of the tile exchanged
        return torch.roll(_tf32_chained_once(a, b), a.shape[0] // 2, 0)
    return _tf32_chained_once(a[:, :-8], b[:-8])  # the last k8 step dropped


@pytest.mark.parametrize("case", ["emulated", "zeros", "rows_swapped", "last_step_dropped"])
def test_tf32_bound_at_k4_stage1(case):
    """chip_smoke's 1xTF32 check (largest |Δ| from the plain version over
    kernel_probe.tf32_bound ≤ 1) at K4's stage-1 shape: the kernel's order,
    emulated, passes it; a product with a fault of the kinds a kernel can
    have does not."""
    m, k, n, _ = kernel_probe.K4_STAGE1
    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32))
    b = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32))
    plain = P.f32_product_plain(a, b)[0]
    if case == "emulated":
        got = _tf32_chained_once(b.T.contiguous(), a.T.contiguous()).T
    else:
        got = _broken(case, a, b)
    ratio = float(((got - plain).abs() / kernel_probe.tf32_bound(a, b)).max())
    assert (ratio <= 1.0) if case == "emulated" else (ratio > 1.0)


@pytest.mark.parametrize("scheme,ms,by", [("fma", 0.1683, "operations"),
                                          ("3xtf32", 0.0683, "operations"),
                                          ("tf32", 0.0303, "bytes"),
                                          ("f64tc", 0.1683, "operations")])
def test_p1_bounds_at_k4_stage1(scheme, ms, by):
    """chip_smoke's P1 bounds at K4's stage-1 shape (512 × (48×224)·
    (224×1024)): 11.27 GFLOP per scheme in f32 or FP64 at 67 TFLOP/s, three
    TF32 products at 495; 1xTF32 by writing C's 100.7 MB at 3.35 TB/s."""
    got_ms, got_by = chip_smoke.p1_bounds(*kernel_probe.K4_STAGE1)[scheme]
    assert got_by == by and abs(got_ms - ms) < 5e-5


def test_product_sum_plain_vs_numpy():
    """P2's plain version: reps·Σ_i a·b[i] of the bf16 values, whose products
    are exact in f32, so it differs from the f64 sum only by the f32
    rounding of ~n_img·K terms: within 2·n_img·K·2⁻²⁴ of max|out|."""
    a, b = _p2_inputs()
    reps = 4
    a64 = a.float().numpy().astype(np.float64)
    b64 = b.float().numpy().astype(np.float64)
    want = np.einsum("mk,ikn->mn", a64, b64) * reps
    got = P.product_sum_plain(a, b, reps).numpy()
    assert got.shape == (96, 128) and got.dtype == np.float32
    tol = 2 * b.shape[0] * b.shape[1] * 2.0 ** -24 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("structure", P.STRUCTURES)
def test_product_sum_cpu_takes_plain(structure):
    a, b = _p2_inputs(n_img=5)
    torch.testing.assert_close(P.product_sum(a, b, reps=3, structure=structure),
                               P.product_sum_plain(a, b, 3), rtol=0, atol=0)


def test_product_sum_rejects_unknown_structure():
    a, b = _p2_inputs(n_img=2)
    with pytest.raises(ValueError, match="structure"):
        P.product_sum(a, b, reps=1, structure="tiled")


@pytest.mark.parametrize("n_img,reps", [(64, 4), (9, 2), (201, 4), (1, 1), (40, 3)])
def test_product_sum_split_covers_every_product(n_img, reps):
    """P2's split (csrc/probe.cu): the loop cuts the n_img·reps products
    into at most 128 contiguous slices of equal length, the last possibly
    shorter and none empty; the batched structure gives each image its
    reps products."""
    total = n_img * reps
    per, n_cta = P.product_sum_split("loop", n_img, reps)
    assert n_cta <= P.P2_MAX_SLICES and per * (n_cta - 1) < total <= per * n_cta
    assert P.product_sum_split("batched", n_img, reps) == (reps, n_img)


def test_p2_updates_at_the_probe_shape():
    """The rounded updates behind one output at the probe's shape (K=112,
    64 images, 4 reps): the loop chains 2 products' 7 wgmma steps, then
    adds 128 partials; the batched structure chains 4 products, then adds
    64 column blocks."""
    assert kernel_probe.p2_updates("loop", 64, 4, 112) == 2 * 7 + 128
    assert kernel_probe.p2_updates("batched", 64, 4, 112) == 4 * 7 + 64


@pytest.mark.parametrize("n_img,reps", [(64, 4), (201, 4), (9, 2)])
def test_product_sum_loop_is_rep_major(n_img, reps):
    """The loop takes the products in the TPU kernel's order
    (tools/kernel_probe.py:_loop_mm_kernel: reps outer, images inner), so
    a CTA's slice chains products of different images (two at the probe's
    shape), each image comes back once per rep, and every (image, rep)
    product is issued once; the batched structure's CTA b issues image b's
    reps."""
    total = n_img * reps
    order = [P.product_image("loop", q, n_img, reps) for q in range(total)]
    assert order == [i for _ in range(reps) for i in range(n_img)]
    per, n_cta = P.product_sum_split("loop", n_img, reps)
    for blk in range(n_cta):
        imgs = order[blk * per:(blk + 1) * per]
        assert len(set(imgs)) == len(imgs) == min(per, total - blk * per)
    bper, _ = P.product_sum_split("batched", n_img, reps)
    assert [P.product_image("batched", q, n_img, reps) for q in range(total)] == [
        q // bper for q in range(total)]


@pytest.mark.parametrize("structure", P.STRUCTURES)
def test_product_sum_split_order_within_bound(structure):
    """The kernel's summation order, replayed in f32 on the CPU (each CTA's
    products added in turn, the loop's in rep-major order, then the CTAs'
    partials in order), stays within the probe tool's bound
    2·updates·2⁻²³·max|out| of the plain version."""
    n_img, reps = 24, 3
    a, b = _p2_inputs(n_img=n_img)
    per, n_cta = P.product_sum_split(structure, n_img, reps)
    prods = (a.float() @ b.float()).numpy()  # exact: bf16 products in f32
    parts = []
    for blk in range(n_cta):
        acc = np.zeros((96, 128), np.float32)
        for q in range(blk * per, min((blk + 1) * per, n_img * reps)):
            acc = (acc + prods[P.product_image(structure, q, n_img, reps)]).astype(np.float32)
        parts.append(acc)
    got = np.zeros((96, 128), np.float32)
    for part in parts:
        got = (got + part).astype(np.float32)
    want = P.product_sum_plain(a, b, reps).numpy()
    tol = 2 * kernel_probe.p2_updates(structure, n_img, reps, 112) * 2.0 ** -23 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


def _small_compare_args(rng, n=48, n_fold=2, o=2, c=2, i=8):
    """K1/K4 inputs at D = 21 (the variants' tiling), a small N."""
    from bioem_tpu_torch.core.posterior import displacement_dft_weights

    f, m = n // 2 + 1, n // n_fold
    disp = np.concatenate([np.arange(0, 21, 2), np.arange(-20, 0, 2)]).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    g = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))  # noqa: E731
    r = lambda *s: g(rng.normal(0, 1, s))  # noqa: E731
    return (r(o, n, f), r(o, n, f), r(c, n, f), r(c, n, f), r(i, n, f), r(i, n, f),
            g(wx.real[:, :m]), g(wx.imag[:, :m]), g(wy.real), g(wy.imag),
            g(np.abs(rng.normal(0, 1e-5, (o * c, i)))), g(np.abs(rng.normal(0, 1e-8, (o * c, i)))))


@pytest.mark.parametrize("body", ["k1", "k4"])
def test_body_ablation_full_on_cpu_is_the_plain_version(rng, body):
    args = _small_compare_args(rng)
    got = P.body_ablation(*args, a_coef=-1151.5, n_fold=2, body=body, variant="full")
    want = C.fused_compare_block_plain(*args, a_coef=-1151.5, n_fold=2)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("body,variant", [("k1", "no_lse"), ("k1", "mm_only"),
                                          ("k1", "no_gemm"), ("k1", "no_stage2"),
                                          ("k4", "no_lse"), ("k4", "mm_only"),
                                          ("k4", "no_gemm")])
def test_body_ablation_variants_have_no_plain_version(rng, body, variant):
    """An ablated body is wrong by design and timed on the card only."""
    args = _small_compare_args(rng)
    with pytest.raises(ValueError, match="no plain version"):
        P.body_ablation(*args, a_coef=-1.0, n_fold=2, body=body, variant=variant)


def test_body_ablation_rejects_unknown_variants(rng):
    args = _small_compare_args(rng)
    for body, variant in (("k1", "no_fold"), ("k4", "no_fold"), ("k2", "full"),
                          ("k4", "no_stage2")):
        with pytest.raises(ValueError, match="no variant"):
            P.body_ablation(*args, a_coef=-1.0, n_fold=2, body=body, variant=variant)


def test_production_block_inputs_shapes():
    """P3 runs at the production block: O=8, C=8, I=64, N=224, F=113,
    D=21, n_fold=2 (built here on the CPU; no kernel runs)."""
    args, a_coef, n_fold = kernel_probe.production_block_inputs("cpu")
    assert [tuple(t.shape) for t in args] == [
        (8, 224, 113), (8, 224, 113), (8, 224, 113), (8, 224, 113),
        (64, 224, 113), (64, 224, 113), (21, 112), (21, 112), (21, 113), (21, 113),
        (64, 64), (64, 64)]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in args)
    assert n_fold == 2 and a_coef == (3.0 - 224 * 224) / 2


@pytest.mark.parametrize("probe", ["main", "probe_f32_accuracy", "probe_issue_overhead",
                                   "probe_body_ablation"])
def test_probe_tool_refuses_without_card(monkeypatch, probe):
    """A probe's answer is a measurement of the card: no CPU mode."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(kernel_probe, probe)()


def test_kernel_ab_refuses_without_card(monkeypatch, tmp_path):
    """The A/B tool times the card: no CPU mode; a root without the port
    is refused before anything is built."""
    from bioem_tpu_torch.tools import kernel_ab

    with pytest.raises(FileNotFoundError, match="_build.py"):
        kernel_ab.other_library(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_ab.main([str(tmp_path)])
