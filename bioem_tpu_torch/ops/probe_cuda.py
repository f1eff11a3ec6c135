"""The kernel probes P1–P3: wrappers and plain versions.

Replaces the TPU micro-probes of ``tools/kernel_probe.py`` (P1
``_f32_dot_kernel``, P2 ``_loop_mm_kernel``/``_batched_mm_kernel``, P3
``probe_body_ablation``'s ``body(variant).kern``); each answers the TPU
probe's question asked of the card (see ``csrc/probe.cu`` for P1 and P2,
and the body variants of ``csrc/compare_fused.cu`` and ``csrc/compare_batched.cu``
for P3):

* P1 :func:`f32_product` — one f32 product in a named scheme (FP32 FMA,
  3xTF32, 1xTF32, FP64 tensor cores), for its accuracy and its cost;
* P2 :func:`product_sum` — reps · Σ_i A·B_i in bf16 with f32
  accumulation across the card, looped (contiguous slices of the image ×
  rep products in the TPU kernel's order, reps outer and images inner,
  each slice into one accumulator, then a sum of the slices' partials) or
  batched (one wide product, then a reduction over its
  column blocks);
* P3 :func:`body_ablation` — the production comparison body of K1 or K4
  with pieces removed; only ``full`` (the production instance itself)
  has a result, the other variants write a checksum into ``m``.

A CPU tensor gets the plain torch version; a CUDA tensor gets the kernel
or an exception. P3's ablated variants are wrong by design and have no
plain version: they raise on the CPU.
"""

from __future__ import annotations

import torch

from . import _build
from .compare_cuda import (
    _check_launch,
    _compare_dims,
    _summary_outputs,
    batched_smem_bytes,
    fused_compare_block_plain,
    launch_k1,
)

F32 = torch.float32
BF16 = torch.bfloat16

SCHEMES = ("fma", "3xtf32", "tf32", "f64tc")  # csrc/probe.cu Scheme
STRUCTURES = ("loop", "batched")  # csrc/probe.cu Structure
VARIANTS = ("full", "no_lse", "mm_only", "no_gemm", "no_stage2")  # csrc/compare_lse.cuh Body
# The variants each body has: no_stage2 is K1's (its wide chunk, D = 65..88).
BODY_VARIANTS = {"k1": VARIANTS, "k4": VARIANTS[:4]}


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

def f32_product_plain(a: torch.Tensor, b: torch.Tensor, batch: int = 1) -> torch.Tensor:
    """(batch, M, N) copies of a·b, each product computed in f64 and
    rounded to f32 once (the same work as the kernel's ``batch`` copies)."""
    return torch.matmul(a.double().expand(batch, *a.shape), b.double()).float()


def f32_product(a: torch.Tensor, b: torch.Tensor, *, scheme: str,
                batch: int = 1) -> torch.Tensor:
    """P1: ``batch`` copies of a·b, a (M, K) and b (K, N) f32, computed in
    ``scheme`` (one of :data:`SCHEMES`); returns (batch, M, N) f32."""
    if scheme not in SCHEMES:
        raise ValueError(f"f32_product: scheme {scheme!r} not in {SCHEMES}")
    dev = a.device
    if dev.type == "cpu":
        return f32_product_plain(a, b, batch)
    if dev.type != "cuda":
        raise ValueError(f"f32_product: unsupported device {dev}")
    m, k = a.shape
    n = b.shape[1]
    for name, t, shape in (("a", a, (m, k)), ("b", b, (k, n))):
        if t.device != dev or t.dtype != F32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"f32_product: {name} must be contiguous float32 {shape} on {dev}")
    if not 1 <= batch <= 65535:
        raise ValueError(f"f32_product: batch {batch} outside [1, 65535]")
    out = torch.empty((batch, m, n), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        status = _build.load().bioem_probe_f32_product(
            SCHEMES.index(scheme), a.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, k, n, batch, _stream(dev))
    _build.check(status, "f32_product")
    f32_product.launches += 1
    return out


f32_product.launches = 0


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------

def product_sum_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """reps · Σ_i a·b[i] in f32 (bf16 inputs are exact in f32)."""
    return (a.float() @ b.float()).sum(dim=0) * reps


# The loop structure's CTAs (each one partial) at most: csrc/probe.cu kMaxSlices.
P2_MAX_SLICES = 128


def product_sum_split(structure: str, n_img: int, reps: int) -> tuple:
    """(products per CTA, CTAs) of P2's ``structure``: the loop splits the
    n_img·reps products, in :func:`product_image`'s order, into at most
    :data:`P2_MAX_SLICES` contiguous slices of equal length (the last may
    be shorter); the batched structure gives each image (its ``reps``
    products) a CTA."""
    if structure == "batched":
        return reps, n_img
    total = n_img * reps
    per = -(-total // P2_MAX_SLICES)
    return per, -(-total // per)


def product_image(structure: str, q: int, n_img: int, reps: int) -> int:
    """The image of P2's product ``q``: the loop takes the products in the
    TPU kernel's order, reps outer and images inner (a CTA's slice chains
    the products of different images, each B_i staged in turn); the
    batched structure's CTA ``q // reps`` issues one image's reps."""
    return q % n_img if structure == "loop" else q // reps


def product_sum(a: torch.Tensor, b: torch.Tensor, *, reps: int, structure: str) -> torch.Tensor:
    """P2: reps · Σ_i a·b[i], a (96, K) and b (n_img, K, 128) bf16, f32
    accumulation, on the card's warpgroup tensor cores, looped or batched
    (one of :data:`STRUCTURES`, split as :func:`product_sum_split` says);
    returns (96, 128) f32."""
    if structure not in STRUCTURES:
        raise ValueError(f"product_sum: structure {structure!r} not in {STRUCTURES}")
    dev = a.device
    if dev.type == "cpu":
        return product_sum_plain(a, b, reps)
    if dev.type != "cuda":
        raise ValueError(f"product_sum: unsupported device {dev}")
    m, k = a.shape
    n_img, _, n = b.shape
    if (m, n) != (96, 128) or k % 16 or not 16 <= k <= 128:
        raise ValueError(f"product_sum: needs a (96, K) and b (n_img, K, 128) with K a "
                         f"multiple of 16 up to 128, got {tuple(a.shape)}, {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.device != dev or t.dtype != BF16 or not t.is_contiguous():
            raise ValueError(f"product_sum: {name} must be contiguous bfloat16 on {dev}")
    if b.shape[1] != k or reps < 1:
        raise ValueError("product_sum: b's depth must be a's, reps ≥ 1")
    per, n_cta = product_sum_split(structure, n_img, reps)
    out = torch.empty((m, n), dtype=F32, device=dev)
    # the CTAs' partials (loop) or the wide product (batched), as many floats either way
    scratch = torch.empty((n_cta, m, n), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        status = _build.load().bioem_probe_product_sum(
            STRUCTURES.index(structure), a.data_ptr(), b.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), m, k, n, n_img, reps, per, _stream(dev))
    _build.check(status, "product_sum")
    product_sum.launches += 1
    return out


product_sum.launches = 0


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------

def body_ablation(*args, a_coef: float, n_fold: int = 1, body: str = "k4",
                  variant: str = "full", img_tile: int = 8):
    """P3: the comparison body of K1 (``body="k1"``) or K4 (``"k4"``, at
    ``img_tile``) in ``variant`` (one of :data:`VARIANTS`) on the twelve
    inputs of ``compare_cuda.fused_compare_block``. Returns (m, se, ds,
    ccs) as the production kernel does for ``full``; for the ablated
    variants ``m`` holds a checksum and the rest is zero (``no_gemm``
    writes every output, its cc being 0). The variants exist for K1
    (``compare_cuda.k1_plan``) at four warpgroups with row chunks of 2·dc =
    48 (D = 17..24, the production block) and 64 (D = 25..32 and the
    lattices of 32-row chunks, D ≥ 129), and at two warpgroups with one
    wide chunk of 2·dc = 176 (D = 65..88, the reference grid's D = 81; the
    only tiling with ``no_stage2``: stage 1 and the log-sum-exp over a
    zeroed lattice, so that full − no_stage2 is stage 2), for K4 at the
    production tiling, 2·Dp = 48, at any tile (:data:`BODY_VARIANTS`)."""
    if variant not in BODY_VARIANTS.get(body, ()):
        raise ValueError(f"body_ablation: no variant {variant!r} of {body!r}")
    dev = args[0].device
    if dev.type == "cpu":
        if variant != "full":
            raise ValueError(f"body_ablation: {variant!r} is an ablation, wrong by design, "
                             "timed on the card only; it has no plain version")
        return fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    if dev.type != "cuda":
        raise ValueError(f"body_ablation: unsupported device {dev}")
    fn = "body_ablation"
    o_n, c_n, i_n, n, f, d, m = _compare_dims(fn, args)
    outs = _summary_outputs(o_n * c_n, i_n, dev)
    if variant != "full":
        for t in outs:  # an ablated body writes only m
            t.zero_()
    if body == "k1":
        launch_k1(f"{fn} ({body}, {variant})", args, a_coef, n_fold,
                  variant=VARIANTS.index(variant), outs=outs)
    else:
        if img_tile < 1 or i_n % img_tile:
            raise ValueError(f"{fn}: image count {i_n} not a multiple of tile {img_tile}")
        _check_launch(fn, batched_smem_bytes(d, m, f), d, m, n, n_fold, o_n * c_n)
        with torch.cuda.device(dev):
            status = _build.load().bioem_probe_compare_batched(
                VARIANTS.index(variant), *(t.data_ptr() for t in args), float(a_coef), o_n,
                c_n, i_n, n, f, d, m, n_fold, img_tile, *(t.data_ptr() for t in outs),
                _stream(dev))
        _build.check(status, f"{fn} ({body}, {variant})")
    body_ablation.launches += 1
    return outs


body_ablation.launches = 0
