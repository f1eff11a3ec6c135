"""Kernel probes P1–P3 on the card (counterpart of ``tools/kernel_probe.py``).

Each probe asks of the card the question its TPU probe asked of the TPU,
through the port's own kernels (``ops/probe_cuda.py``):

P1  Which f32-product scheme holds the accuracy contract, and at what cost?
    The (96,112)·(112,113) product of the TPU probe's inputs in FP32 FMA
    (the earlier K1 and K3 bodies), 3xTF32 (K1's, K3's and K4's stage 1),
    1xTF32 and FP64 tensor cores: median and max relative error against
    an f64 NumPy product; then, at
    that shape and at K4's stage-1 shape over a production block (512 tile
    products of (48×224)·(224×1024)), each scheme's output against the
    plain version (every batch copy) and its time.
P2  What does a looped small product cost against one wide product? Σ of
    64 bf16 products (96,112)·(112,128), 4 times, on wgmma across the
    card: the products in the TPU kernel's order (reps outer, images
    inner) cut into slices, each slice's products of different images
    chained into one accumulator, then a sum of the slices (K1's
    structure), vs one wide product and a column-block reduction (K4's
    structure); beside one cuBLAS GEMM that does all 256 products.
P3  Where does the production body spend its time? K1 and K4 (tile 8) at
    the production block (O=8, C=8, I=64, N=224, F=113, D=21, n_fold=2)
    with pieces removed: ``full``, ``no_lse``, ``mm_only`` and ``no_gemm``;
    ``full`` must equal the production kernel bit for bit.

Besides, K2's card time at the production projection block against the
number of point slots it reads: none, the model's points, every slot
(``probe_projection_points``): its fixed cost and its cost per point.

Usage, on a machine with a CUDA card (there is no CPU mode: a probe's
answer is a measurement of the card):

    python -m bioem_tpu_torch.tools.kernel_probe

Every time is a mean over timed launches after a warm-up, from CUDA events;
P2's are the card's own time, its calls queued behind a spin of the card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.posterior import displacement_dft_weights
from ..ops import compare_cuda, probe_cuda

# P2's shapes (the TPU probe's): m, k, n, images, reps.
P2_SHAPE = (96, 112, 128, 64, 4)
# K4's stage 1 over a production block at tile 8: (2·Dp × 2·Mp) · (2·Mp ×
# tile·128 columns), 64 o·c pairs × 8 tiles.
K4_STAGE1 = (48, 224, 8 * 128, 64 * 8)


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call of the card's own time: the calls are
    queued behind a ~20 ms spin of the card (``torch.cuda._sleep``), so the
    host's time to launch them, which the queue hides, does not enter. For
    calls of tens of microseconds, where :func:`time_ms` times the host.
    (A ~2 ms spin did not always cover 20 calls issued at up to ~60 µs
    each: one P2 reading came out 4× its neighbours.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # cycles
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel probes measure the card: no CUDA device "
                           "(torch.cuda.is_available() is false)")
    return torch.device("cuda")


def probe_f32_accuracy(say=print) -> dict:
    """P1. Returns {"err": {scheme: (median, max) relative to f64 at the
    TPU probe's shape}, and for each shape name in "shapes" ({shape: (M, K,
    N, batch)}): "plain_err" {shape: {scheme: (median relative, max |Δ|)
    of every batch copy from the plain version}}, "copies_equal" {shape:
    {scheme: every copy equal to copy 0}}, "ms" {shape: {scheme: ms}},
    "plain_ms" {shape: ms} and "library_ms" {shape: ms}, each timing all
    ``batch`` products."""
    dev = _require_card()
    m, k, n = 96, 112, 113
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    b = rng.normal(0, 1, (k, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    out = {"err": {}, "plain_err": {}, "copies_equal": {}, "ms": {}, "plain_ms": {},
           "library_ms": {}, "shapes": {"probe": (m, k, n, 1), "k4_stage1": K4_STAGE1}}
    for scheme in probe_cuda.SCHEMES:
        got = probe_cuda.f32_product(ta, tb, scheme=scheme)[0].cpu().numpy()
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
        med, mx = float(np.median(rel)), float(rel.max())
        out["err"][scheme] = (med, mx)
        say(f"P1 {scheme}: rel err vs f64 median={med:.2e} max={mx:.2e} -> "
            f"{'f32-accurate (median < 1e-6)' if med < 1e-6 else 'below f32 accuracy'}")
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # the yardstick is SGEMM, not TF32
    try:
        for shape, (sm, sk, sn, batch) in out["shapes"].items():
            xa = torch.as_tensor(rng.normal(0, 1, (sm, sk)).astype(np.float32), device=dev)
            xb = torch.as_tensor(rng.normal(0, 1, (sk, sn)).astype(np.float32), device=dev)
            plain = probe_cuda.f32_product_plain(xa, xb, batch)
            out["plain_err"][shape], out["copies_equal"][shape] = {}, {}
            for s in probe_cuda.SCHEMES:
                got = probe_cuda.f32_product(xa, xb, scheme=s, batch=batch)
                rel = (got[0] - plain[0]).abs() / plain[0].abs().clamp_min(1e-30)
                out["plain_err"][shape][s] = (float(rel.median()),
                                              float((got - plain).abs().max()))
                out["copies_equal"][shape][s] = bool(torch.equal(got, got[:1].expand_as(got)))
                del got
            del plain
            say(f"P1 at ({sm},{sk})·({sk},{sn}) × {batch} vs the plain version: "
                + ", ".join(f"{s} median rel {e[0]:.2e} max |Δ| {e[1]:.2e}"
                            f"{'' if out['copies_equal'][shape][s] else ' (COPIES DIFFER)'}"
                            for s, e in out["plain_err"][shape].items()))
            out["ms"][shape] = {s: time_ms(lambda s=s: probe_cuda.f32_product(
                xa, xb, scheme=s, batch=batch)) for s in probe_cuda.SCHEMES}
            out["plain_ms"][shape] = time_ms(lambda: probe_cuda.f32_product_plain(xa, xb, batch), 3)
            xa_b = xa.expand(batch, sm, sk)
            out["library_ms"][shape] = time_ms(lambda: torch.matmul(xa_b, xb))
            say(f"P1 times at ({sm},{sk})·({sk},{sn}) × {batch}: "
                + ", ".join(f"{s} {t:.4f} ms" for s, t in out["ms"][shape].items())
                + f"; plain (f64, all {batch} products) {out['plain_ms'][shape]:.4f} ms, "
                  f"torch.matmul f32 {out['library_ms'][shape]:.4f} ms")
    finally:
        torch.set_float32_matmul_precision(prec)
    return out


def p2_updates(structure: str, n_img: int, reps: int, k: int) -> int:
    """Rounded accumulator updates behind one output of P2's ``structure``:
    each CTA chains its products' K/16 wgmma steps into one accumulator,
    then the second pass adds the CTAs' partials one by one
    (probe_cuda.product_sum_split gives the split). The count does not
    depend on which image each product is of (probe_cuda.product_image):
    the loop's rep-major order changes the terms, not their number."""
    per, n_cta = probe_cuda.product_sum_split(structure, n_img, reps)
    return per * (k // 16) + n_cta


def probe_issue_overhead(say=print) -> dict:
    """P2. Returns {"ms": {structure: ms}, "host_ms": {structure: ms},
    "err": {structure: max |Δ|}, "tol": {structure: tolerance}, "plain_ms",
    "library_ms", "library_host_ms", "library_err", "shape"}: "ms" and
    "library_ms" are the card's time (:func:`device_ms`), the "host_ms"
    ones the rate at which the host issues the calls (:func:`time_ms`),
    which a call this short does not outrun.

    Tolerance: bf16 products are exact in f32, so the two structures and
    the plain version differ only in the f32 rounding of their running
    sums. Each accumulator update rounds by at most 2⁻²³ of the partial sum
    (the tensor cores truncate), and the partial sums stay within ~2·max|out|,
    so |Δ| ≤ 2 · updates · 2⁻²³ · max|out|, with updates from
    :func:`p2_updates`: per·K/16 + CTAs, where the loop puts ⌈images·reps /
    128⌉ consecutive products of its rep-major order (two images' at the
    probe's shape) in each of its CTAs and the batched structure an image's
    reps in each of its n_img CTAs.

    The library time is one cuBLAS GEMM doing every product: [A … A] (96 ×
    images·reps·K) times the images' B stacked reps times ((images·reps·K)
    × 128), bf16 in and out (it rounds its f32 sum to bf16)."""
    dev = _require_card()
    m, k, n, n_img, reps = P2_SHAPE
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.as_tensor(rng.normal(0, 1, (n_img, k, n)).astype(np.float32)).to(dev, torch.bfloat16)
    plain = probe_cuda.product_sum_plain(a, b, reps)
    scale = float(plain.abs().max())
    out = {"ms": {}, "host_ms": {}, "err": {}, "tol": {}, "shape": P2_SHAPE}
    for st in probe_cuda.STRUCTURES:
        got = probe_cuda.product_sum(a, b, reps=reps, structure=st)
        out["err"][st] = float((got - plain).abs().max())
        out["tol"][st] = 2 * p2_updates(st, n_img, reps, k) * 2.0 ** -23 * scale
        call = lambda st=st: probe_cuda.product_sum(a, b, reps=reps, structure=st)  # noqa: E731
        out["ms"][st] = device_ms(call)
        out["host_ms"][st] = time_ms(call)
        us = out["ms"][st] * 1e3
        say(f"P2 {st}: {us:.1f} us/call on the card ({us * 1e3 / (n_img * reps):.0f} ns per "
            f"{m}x{k}x{n} product-equivalent; {out['host_ms'][st] * 1e3:.1f} us per call "
            f"issued from the host); max |Δ| vs plain {out['err'][st]:.3e} "
            f"(tol {out['tol'][st]:.3e})")
    out["plain_ms"] = time_ms(lambda: probe_cuda.product_sum_plain(a, b, reps))
    a_wide = a.repeat(1, n_img * reps)
    b_tall = b.repeat(reps, 1, 1).reshape(n_img * reps * k, n)
    lib = torch.mm(a_wide, b_tall)
    out["library_err"] = float((lib.float() - plain).abs().max())
    out["library_ms"] = device_ms(lambda: torch.mm(a_wide, b_tall))
    out["library_host_ms"] = time_ms(lambda: torch.mm(a_wide, b_tall))
    say(f"P2 issue-overhead ratio loop/batched: {out['ms']['loop'] / out['ms']['batched']:.2f}x; "
        f"plain {out['plain_ms'] * 1e3:.1f} us, torch.mm bf16 over all {n_img * reps} products "
        f"{out['library_ms'] * 1e3:.1f} us on the card ({out['library_host_ms'] * 1e3:.1f} us "
        f"issued from the host; max |Δ| vs plain {out['library_err']:.3e}, bf16 output)")
    return out


def production_block_inputs(dev, seed: int = 2):
    """Random inputs of one production comparison block (O=8, C=8, I=64,
    N=224, F=113, D=21 at stride 2, n_fold=2) with the true lattice DFT
    weights: the twelve arguments of fused_compare_block, a_coef and
    n_fold."""
    o, c, i, n, n_fold = 8, 8, 64, 224, 2
    f, m = n // 2 + 1, n // n_fold
    disp = np.concatenate([np.arange(0, 21, 2), np.arange(-20, 0, 2)]).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    rng = np.random.default_rng(seed)
    g = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)  # noqa: E731
    r = lambda *s: g(rng.normal(0, 1, s))  # noqa: E731
    args = (r(o, n, f), r(o, n, f), r(c, n, f), r(c, n, f), r(i, n, f), r(i, n, f),
            g(wx.real[:, :m]), g(wx.imag[:, :m]), g(wy.real), g(wy.imag),
            g(np.abs(rng.normal(0, 1e-6, (o * c, i)))), g(np.abs(rng.normal(0, 1e-9, (o * c, i)))))
    return args, (3.0 - n * n) * 0.5, n_fold


PROJ_GROUP_POINTS = (80, 80, 60, 50, 40, 35, 30, 30, 25, 20, 20, 15, 10, 5)


def production_projection_inputs(dev, seed: int = 3):
    """Random inputs of one production projection block (O=8, N=224, a
    500-point model in G=14 radius groups padded to Pp=80, as the
    production problem's): i0, j0 (pixel positions within ±112, some
    outside the grid), densities (zero on each group's padding and on ~5 %
    of the points, as the bounds mask leaves them), the stencil bank and
    the per-group point counts; the arguments of fourier_project_block."""
    o, n, pp = 8, 224, 80
    f, g = n // 2 + 1, len(PROJ_GROUP_POINTS)
    rng = np.random.default_rng(seed)
    counts = np.array(PROJ_GROUP_POINTS, np.int32)
    live = np.arange(pp)[None, None, :] < counts[:, None, None]
    dens = rng.uniform(0.5, 2.0, (g, o, pp)) * live * (rng.uniform(size=(g, o, pp)) > 0.05)
    ij = lambda: rng.integers(-n // 2 - 8, n // 2 + 8, (g, o, pp)).astype(np.int32)  # noqa: E731
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    st = rng.normal(0, 1, (2, g, n, f)).astype(np.float32)
    return (t(ij()), t(ij()), t(dens.astype(np.float32)), t(st[0]), t(st[1]), t(counts))


def probe_projection_points(say=print) -> dict:
    """K2's time against the point slots it reads, at the production
    projection block: none (what it pays whatever the model: the twiddle
    table, the partial spectra, the output), the model's 500 points (the
    production counts) and every slot, padding included (1120). Returns
    {"ms": {label: ms}, "points": {label: slots read}, "max_rel_diff": max
    |Δ| between the model's and every slot's spectra over max|spectrum|
    (the padding holds zero density, so only the order of the adds
    differs)}."""
    from ..ops import project_cuda

    dev = _require_card()
    i0, j0, dens, st_re, st_im, counts = production_projection_inputs(dev)
    n, pp = st_re.shape[1], i0.shape[2]
    runs = {"none": torch.zeros_like(counts), "model": counts,
            "every slot": torch.full_like(counts, pp)}
    out = {"ms": {}, "points": {}}
    spectra = {}
    for label, c in runs.items():
        def call(c=c):
            return project_cuda.fourier_project_block(i0, j0, dens, st_re, st_im, n=n, counts=c)

        spectra[label] = call()
        out["ms"][label] = device_ms(call)
        out["points"][label] = int(c.sum())
    scale = max(float(x.abs().max()) for x in spectra["model"])
    out["max_rel_diff"] = max(float((x - y).abs().max())
                              for x, y in zip(spectra["model"], spectra["every slot"])) / scale
    slope = ((out["ms"]["every slot"] - out["ms"]["model"])
             / (out["points"]["every slot"] - out["points"]["model"]))
    say("K2 against the point slots it reads (production projection block, card time): "
        + ", ".join(f"{k} ({out['points'][k]}) {t:.4f} ms" for k, t in out["ms"].items())
        + f"; {slope * 1e6:.1f} ns per slot; model vs every slot max |Δ| "
          f"{out['max_rel_diff']:.2e} of max|spectrum|")
    return out


def probe_body_ablation(say=print, img_tile: int = 8) -> dict:
    """P3. Returns {"ms": {(body, variant): ms}, "bit_equal": {body: bool},
    "comparisons": n, "dims": the block's (O, C, I, N, F, D, M, n_fold),
    "max_abs_err": max |Δm| of K4's full body from the plain version,
    "plain_ms": the plain version's time}."""
    dev = _require_card()
    args, a_coef, n_fold = production_block_inputs(dev)
    (o, n, f), c, i, (d, m) = args[0].shape, args[2].shape[0], args[4].shape[0], args[6].shape
    n_cmp = o * c * i
    prod = {"k1": compare_cuda.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold),
            "k4": compare_cuda.fused_compare_block_batched(*args, a_coef=a_coef, n_fold=n_fold,
                                                            img_tile=img_tile)}
    plain = compare_cuda.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    out = {"ms": {}, "bit_equal": {}, "comparisons": n_cmp,
           "dims": (o, c, i, n, f, d, m, n_fold),
           "max_abs_err": float((prod["k4"][0] - plain[0]).abs().max()),
           "plain_ms": time_ms(lambda: compare_cuda.fused_compare_block_plain(
               *args, a_coef=a_coef, n_fold=n_fold), 3)}
    for body in ("k1", "k4"):
        for variant in probe_cuda.VARIANTS:
            def run(body=body, variant=variant):
                return probe_cuda.body_ablation(*args, a_coef=a_coef, n_fold=n_fold, body=body,
                                                variant=variant, img_tile=img_tile)

            res = run()
            if variant == "full":
                out["bit_equal"][body] = all(torch.equal(x, y) for x, y in zip(res, prod[body]))
            else:
                torch.cuda.synchronize()
            t = time_ms(run)
            out["ms"][(body, variant)] = t
            note = (f"; bit-equal to the production kernel: {out['bit_equal'][body]}"
                    if variant == "full" else "")
            say(f"P3 {body}{' tile ' + str(img_tile) if body == 'k4' else ''} {variant}: "
                f"{t:.4f} ms per production block ({t * 1e6 / n_cmp:.1f} ns per comparison){note}")
    return out


def main(argv=None) -> int:
    dev = _require_card()
    print(f"card: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    probe_f32_accuracy()
    probe_issue_overhead()
    probe_body_ablation()
    probe_projection_points()
    return 0


if __name__ == "__main__":
    sys.exit(main())
