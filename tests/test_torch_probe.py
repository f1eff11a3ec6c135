"""The kernel probes P1–P3 (``ops/probe_cuda.py``,
``bioem_tpu_torch.tools.kernel_probe``) on the CPU: the plain versions
against NumPy in f64, the wrappers taking their plain versions on CPU
tensors, and the probe tool refusing to run without a card. The kernels
themselves run in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from bioem_tpu_torch.ops import compare_cuda as C
from bioem_tpu_torch.ops import probe_cuda as P
from bioem_tpu_torch.tools import kernel_probe


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
                                          ("k1", "no_gemm"),
                                          ("k4", "no_lse"), ("k4", "mm_only"),
                                          ("k4", "no_gemm")])
def test_body_ablation_variants_have_no_plain_version(rng, body, variant):
    """An ablated body is wrong by design and timed on the card only."""
    args = _small_compare_args(rng)
    with pytest.raises(ValueError, match="no plain version"):
        P.body_ablation(*args, a_coef=-1.0, n_fold=2, body=body, variant=variant)


def test_body_ablation_rejects_unknown_variants(rng):
    args = _small_compare_args(rng)
    for body, variant in (("k1", "no_fold"), ("k4", "no_fold"), ("k2", "full")):
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
