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
    plain version (every batch copy; 1xTF32 against its rounding bound,
    :func:`tf32_bound`) and its time on the card, beside torch.matmul
    f32's.
P2  What does a looped small product cost against one wide product? Σ of
    64 bf16 products (96,112)·(112,128), 4 times, on wgmma across the
    card: the products in the TPU kernel's order (reps outer, images
    inner) cut into slices, each slice's products of different images
    chained into one accumulator, then a sum of the slices (K1's
    structure), vs one wide product and a column-block reduction (K4's
    structure); beside one cuBLAS GEMM that does all 256 products.
P3  Where does the production body spend its time? K1 and K4 (tile 8) at
    the production block (O=8, C=8, I=64, N=224, F=113, D=21, n_fold=2)
    with pieces removed: ``full``, ``no_lse``, ``mm_only`` and ``no_gemm``,
    and at the reference block (K1 alone, D = 81) also ``no_stage2``
    (everything but stage 2: full − no_stage2 is stage 2's time);
    ``full`` must equal the production kernel bit for bit.

Besides, K2's card time at the production projection block against the
number of point slots it reads: none, the model's points, every slot
(``probe_projection_points``): its fixed cost and its cost per point; and
G4's, its plain version's and cuFFT's rfft2's card time at the production
raster block (``raster_times``); and the block step's posterior glue, G1
and G2, beside the floor of a kernel's time (``glue_attribution``). The
inputs and checks of the projection's glue kernels G3
(``prologue_inputs``, ``check_prologue``) and G4 (``raster_inputs``,
``check_raster``) live here too, for chip_smoke.py and the card tests.

Usage, on a machine with a CUDA card (there is no CPU mode: a probe's
answer is a measurement of the card):

    python -m bioem_tpu_torch.tools.kernel_probe [--glue] [--p3 production|reference]

(``--glue``: only the glue's times, at the production block's
shapes on random inputs; ``--p3 BLOCK``: only P3, on that block of
:data:`BLOCKS`.)

Every time is a mean over timed launches after a warm-up, from CUDA events;
P1's and P2's are the card's own time, their calls queued behind a spin of
the card.
"""

from __future__ import annotations

import json
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


def tf32_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise |Δ| bound of a 1xTF32 product a (M, K) · b (K, N) from
    the exact product rounded to f32, in units of |a|·|b|: 2⁻¹⁰ for the
    operands' rounding to TF32 (2⁻¹¹ each), 2⁻²¹ for the cross term and the
    reference's own rounding, and 2⁻²² for each of the K/8 + 1 adds into
    the accumulator, which truncate."""
    scale = a.abs().double() @ b.abs().double()
    return ((2.0 ** -10 + 2.0 ** -21 + (a.shape[1] // 8 + 1) * 2.0 ** -22) * scale).float()


def probe_f32_accuracy(say=print) -> dict:
    """P1. Returns {"err": {scheme: (median, max) relative to f64 at the
    TPU probe's shape}, and for each shape name in "shapes" ({shape: (M, K,
    N, batch)}): "plain_err" {shape: {scheme: (median relative, max |Δ|)
    of every batch copy from the plain version}}, "copies_equal" {shape:
    {scheme: every copy equal to copy 0}}, "ms" {shape: {scheme: ms}},
    "plain_ms" {shape: ms} and "library_ms" {shape: ms}, each timing all
    ``batch`` products; "tf32_bound_ratio" {shape: the largest |Δ| of
    1xTF32's copy 0 from the plain version over :func:`tf32_bound`, ≤ 1
    when it holds}. Kernel and library times are the card's own (:func:`device_ms`), the
    plain version's host-timed (:func:`time_ms`)."""
    dev = _require_card()
    m, k, n = 96, 112, 113
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    b = rng.normal(0, 1, (k, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    out = {"err": {}, "plain_err": {}, "copies_equal": {}, "ms": {}, "plain_ms": {},
           "library_ms": {}, "tf32_bound_ratio": {},
           "shapes": {"probe": (m, k, n, 1), "k4_stage1": K4_STAGE1}}
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
                if s == "tf32":
                    out["tf32_bound_ratio"][shape] = float(
                        ((got[0] - plain[0]).abs() / tf32_bound(xa, xb)).max())
                del got
            del plain
            say(f"P1 at ({sm},{sk})·({sk},{sn}) × {batch} vs the plain version: "
                + ", ".join(f"{s} median rel {e[0]:.2e} max |Δ| {e[1]:.2e}"
                            f"{'' if out['copies_equal'][shape][s] else ' (COPIES DIFFER)'}"
                            for s, e in out["plain_err"][shape].items())
                + f"; tf32 at {out['tf32_bound_ratio'][shape]:.3f} of its rounding bound")
            out["ms"][shape] = {s: device_ms(lambda s=s: probe_cuda.f32_product(
                xa, xb, scheme=s, batch=batch)) for s in probe_cuda.SCHEMES}
            out["plain_ms"][shape] = time_ms(lambda: probe_cuda.f32_product_plain(xa, xb, batch), 3)
            xa_b = xa.expand(batch, sm, sk)
            out["library_ms"][shape] = device_ms(lambda: torch.matmul(xa_b, xb))
            say(f"P1 times at ({sm},{sk})·({sk},{sn}) × {batch} (card time): "
                + ", ".join(f"{s} {t:.4f} ms" for s, t in out["ms"][shape].items())
                + f"; plain (f64, all {batch} products, host-timed) "
                  f"{out['plain_ms'][shape]:.4f} ms, torch.matmul f32 "
                  f"{out['library_ms'][shape]:.4f} ms")
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


def block_inputs(dev, o: int, c: int, i: int, n: int, n_disp: int, stride: int,
                 seed: int = 2):
    """Random inputs of one comparison block at (O, C, I, N) on the lattice
    of ``n_disp`` displacements per axis at ``stride`` (the engine's order:
    0, s, …, then the negative ones; rows folded ``stride`` times), with
    the true lattice DFT weights: the twelve arguments of
    fused_compare_block, a_coef and n_fold. a_u, b_u at the production
    block's scales (1e-6, 1e-9)."""
    f, m = n // 2 + 1, n // stride
    h = n_disp // 2 * stride
    disp = np.concatenate([np.arange(0, h + 1, stride), np.arange(-h, 0, stride)]).astype(np.int32)
    wx, wy = displacement_dft_weights(n, disp)
    rng = np.random.default_rng(seed)
    g = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)  # noqa: E731
    r = lambda *s: g(rng.normal(0, 1, s))  # noqa: E731
    args = (r(o, n, f), r(o, n, f), r(c, n, f), r(c, n, f), r(i, n, f), r(i, n, f),
            g(wx.real[:, :m]), g(wx.imag[:, :m]), g(wy.real), g(wy.imag),
            g(np.abs(rng.normal(0, 1e-6, (o * c, i)))), g(np.abs(rng.normal(0, 1e-9, (o * c, i)))))
    return args, (3.0 - n * n) * 0.5, stride


# The comparison blocks the kernels are timed on: (O, C, I, N, D, stride).
# "reference" is a block of the reference's production grid (4608 × 32
# CTFs × D = 81 at stride 1), "wide" chip_smoke's block of the wide grid
# (D = 121 at stride 1).
BLOCKS = {"production": (8, 8, 64, 224, 21, 2), "reference": (8, 32, 64, 224, 81, 1),
          "wide": (8, 8, 64, 224, 121, 1)}


def production_block_inputs(dev, seed: int = 2):
    """Random inputs of one production comparison block (O=8, C=8, I=64,
    N=224, F=113, D=21 at stride 2, n_fold=2): :func:`block_inputs`."""
    return block_inputs(dev, 8, 8, 64, 224, 21, 2, seed)


def glue_inputs(dev, o: int, c: int, i: int, n: int = 224, n_disp: int = 21, *,
                normalized: bool = True, seed: int = 4) -> dict:
    """Random inputs of the posterior glue (ops/posterior_cuda.py) for one
    block at (O, C, I, N): ``g1``, the nine arguments of block_constants
    (unit-variance spectra; unit-variance images, ssq_ref ≈ N², mean
    removed, sum_ref ≈ 0, or DC-dominated, sum_ref ≈ 3·N²; a mask whose
    last orientation is padding); ``kw``, its keywords; ``se``, ``ds``,
    ``ccs`` and ``m`` (an f32 varying max, the hybrid's), comparison
    summaries at the scales the production block gives; ``disp``, the
    lattice."""
    from ..core.posterior import hermitian_weights

    rng = np.random.default_rng(seed)
    f, ntot = n // 2 + 1, float(n * n)
    g = lambda x, dt=np.float32: torch.as_tensor(np.ascontiguousarray(x, dt), device=dev)  # noqa: E731
    r = lambda *s: g(rng.normal(0, 1, s))  # noqa: E731
    if normalized:
        sum_ref = rng.normal(0, 1e-2, i)
        ssq_ref = ntot * rng.uniform(0.9, 1.1, i)
    else:
        sum_ref = 3 * ntot * rng.uniform(0.9, 1.1, i)
        ssq_ref = sum_ref**2 / ntot + ntot * rng.uniform(0.9, 1.1, i)
    mask = np.ones(o, np.int32)
    mask[-1] = 0
    g1 = (r(o, n, f), r(o, n, f), r(c, n, f), r(c, n, f), g(hermitian_weights(n)),
          g(sum_ref), g(ssq_ref), g(rng.normal(0, 1, c), np.float64), g(mask, np.int32))
    h = n_disp // 2
    return dict(
        g1=g1, kw=dict(ntot=ntot, images_normalized=normalized),
        se=g(rng.uniform(1, 3, (o, c, i))),
        ds=g(rng.integers(0, n_disp * n_disp, (o, c, i)), np.int32),
        ccs=g(rng.normal(0, 1, (o, c, i))), m=g(rng.normal(-5, 1, (o, c, i))),
        disp=g(np.concatenate([np.arange(0, h + 1), np.arange(-h, 0)]), np.int32),
    )


# G2's cases: the fused path (m repaired from ccs), the hybrid's f32 m, a
# partially masked block, a fully masked one, exact ties between pairs
GLUE_CASES = ("fused", "hybrid", "partial", "full", "ties")


def glue_merge_args(x: dict, case: str) -> tuple:
    """merge_block's arguments before the offset, (m, se, ds, ccs, k, f0,
    sum_c, ssq_c, sum_ref, disp), for one of :data:`GLUE_CASES` on ``x``
    (:func:`glue_inputs`): k, f0 and the sums from block_constants' plain
    version, every orientation live but the last for "partial" and none
    for "full"; m the given f32 one for "hybrid", else None (repaired);
    for "ties" the flat pairs 0, 3 and 4 equal on every image and the
    largest by 1e4 (their ds, ssq_c and tuples differ)."""
    from ..ops.posterior_cuda import block_constants_plain

    pr, pi, cr, ci, h, sum_ref, ssq_ref, prior, mask = x["g1"]
    mask = torch.ones_like(mask)
    if case in ("partial", "full"):
        mask[-1 if case == "partial" else slice(None)] = 0
    sum_c, ssq_c, f0, k, _a, _b = block_constants_plain(pr, pi, cr, ci, h, sum_ref, ssq_ref,
                                                        prior, mask, **x["kw"])
    ccs = x["ccs"]
    if case == "ties":
        k, f0, ccs, sum_c = k.clone(), f0.clone(), ccs.clone(), sum_c.clone()
        rows = [a.view(-1, a.shape[-1]) for a in (k, f0, ccs)]
        rows[0][0] += 1e4
        for q in (3, 4):
            for a in rows:
                a[q] = a[0]
            sum_c.view(-1)[q] = sum_c.view(-1)[0]
    m = x["m"] if case == "hybrid" else None
    return m, x["se"], x["ds"], ccs, k, f0, sum_c, ssq_c, sum_ref, x["disp"]


def glue_replay(dev, o: int = 8, c: int = 8, i: int = 64, n_blocks: int = 2) -> tuple:
    """G1 and G2 captured in one CUDA graph on static inputs, G1's workspace
    made before the capture (as an engine holds it), the block's
    orientation offset (and slab column) a 0-d device tensor that the graph
    advances, replayed ``n_blocks`` times, each time on another block's
    inputs (:func:`glue_inputs`, every orientation live) copied in; and
    the same blocks through G1 and G2 called eagerly with int offsets 0,
    O, .... Returns (replayed state, eager state, the graph's block index
    after the replays, the workspace)."""
    from ..core.posterior import init_state
    from ..ops import posterior_cuda as G

    blocks = [glue_inputs(dev, o, c, i, seed=5 + s) for s in range(n_blocks)]
    for x in blocks:
        x["g1"][-1].fill_(1)
    kw, names = blocks[0]["kw"], ("se", "ds", "ccs", "disp")
    static = {"g1": [v.clone() for v in blocks[0]["g1"]],
              **{n: blocks[0][n].clone() for n in names}}
    blk = torch.zeros(1, dtype=torch.long, device=dev)
    state = init_state(i, n_blocks * o, True, dev)
    ws = G.constants_workspace(o, c, i, *static["g1"][0].shape[1:], dev)

    def step(st, x, off, workspace=None):
        sum_c, ssq_c, f0, k, _a, _b = G.block_constants(*x["g1"], **kw, workspace=workspace)
        G.merge_block(st, None, x["se"], x["ds"], x["ccs"], k, f0, sum_c, ssq_c, x["g1"][5],
                      x["disp"], off, ntot=kw["ntot"], ang_offset=off)

    def captured():
        step(state, static, blk[0] * o, ws)
        blk.add_(1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        captured()  # warm-up, as the engine's capture does
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured()
    for dst, src in zip(state, init_state(i, n_blocks * o, True, dev)):
        dst.copy_(src)
    blk.zero_()
    for x in blocks:
        for dst, src in zip(static["g1"], x["g1"]):
            dst.copy_(src)
        for n in names:
            static[n].copy_(x[n])
        graph.replay()
    eager = init_state(i, n_blocks * o, True, dev)
    for b, x in enumerate(blocks):
        step(eager, x, b * o)
    torch.cuda.synchronize(dev)
    return state, eager, int(blk[0]), ws


def glue_attribution(g1, g1_kw, merge_args, workspace=None) -> dict:
    """The card's own time (:func:`device_ms`) of G1 and G2 at one block,
    beside the floor of a kernel's time here (a one-element in-place add):
    G1 on ``g1`` (block_constants' nine inputs) and ``g1_kw``, with
    ``workspace`` (None: one made here, as an engine holds it); G2 on
    ``merge_args`` (merge_block's arguments from m to disp), slabs off and
    on, each call merging into one state (the first call moves the tuples,
    the rest tie with const), the offset a 0-d tensor on the card as a
    captured step passes it. Returns {label: ms}: "floor", "G1", "G2 slabs
    off", "G2 slabs on"."""
    from ..core.posterior import init_state
    from ..ops import posterior_cuda as G

    dev = g1[0].device
    o, c, i = merge_args[1].shape
    ntot = g1_kw["ntot"]
    if workspace is None:
        workspace = G.constants_workspace(o, c, i, *g1[0].shape[1:], dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    one = torch.zeros(1, device=dev)
    out = {"floor": device_ms(lambda: one.add_(1.0)),
           "G1": device_ms(lambda: G.block_constants(*g1, **g1_kw, workspace=workspace))}
    for slabs in (False, True):
        st = init_state(i, 2 * o, slabs, dev)
        out[f"G2 slabs {'on' if slabs else 'off'}"] = device_ms(
            lambda: G.merge_block(st, *merge_args, zero, ntot=ntot))
    return out


def sass_counts(lib_path: str, stems: tuple) -> dict:
    """{stem: {"calls", "local stores", "local loads"}}: per kernel of the
    built library whose name holds ``stem``, the CALL instructions and the
    local-memory stores and loads (a stack frame's traffic) in its SASS,
    from the CUDA toolkit's ``cuobjdump`` (:func:`sass_counts_of`); {} where
    there is none."""
    import shutil
    import subprocess

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    return sass_counts_of(text, stems)


def sass_counts_of(text: str, stems: tuple) -> dict:
    """:func:`sass_counts` of ``cuobjdump -sass`` output ``text``."""
    import re

    out = {}
    for fn in text.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        for stem in stems:
            if stem in name:
                out[stem] = {"calls": len(re.findall(r"\bCALL\.", fn)),
                             "local stores": len(re.findall(r"\bSTL\b", fn)),
                             "local loads": len(re.findall(r"\bLDL\b", fn))}
    return out


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float
    tensors of one dtype (equal values, infinities included, 0)."""
    it, sign = ((torch.int64, 0x7FFFFFFFFFFFFFFF) if a.dtype == torch.float64
                else (torch.int32, 0x7FFFFFFF))
    ia, ib = (torch.where(v < 0, -(v & sign), v).to(torch.int64)
              for v in (a.contiguous().view(it), b.contiguous().view(it)))
    return int(torch.where(a == b, torch.zeros_like(ia), (ia - ib).abs()).max())


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


# G3's blocks (prologue_inputs): the production block, an Euler-grid block
# of the production model, o_block 16, a block of the reference's grid and
# the production model with points outside the frame.
PROLOGUE_CASES = ("production", "euler", "o_block 16", "reference grid", "out of frame")


def _case_block(case: str) -> tuple:
    """(params, angle rows, quaternions?, model) of one block of
    :data:`PROLOGUE_CASES` (:func:`prologue_inputs` says which)."""
    import dataclasses

    from ..core.orientations import euler_grid
    from ..io.model_io import Model
    from ..utils.so3 import super_fibonacci
    from .problem import REFERENCE_GRID, build_problem

    if case not in PROLOGUE_CASES:
        raise ValueError(f"unknown block case {case!r} (one of {PROLOGUE_CASES})")
    p, orients, model, _images, _planted = build_problem(n_img=1)
    ang, quat = orients.angles[:8], True
    if case == "euler":
        grid = euler_grid(dataclasses.replace(p, grid_points_alpha=36, grid_points_beta=18))
        ang, quat = grid.angles[grid.n // 2: grid.n // 2 + 8], False
    elif case == "o_block 16":
        ang = orients.angles[16:32]
    elif case == "reference grid":
        ang = super_fibonacci(REFERENCE_GRID["n_orient"])[:8]
    elif case == "out of frame":
        radii = model.radii.copy()
        radii[::2] = np.float32(0.9 * p.pixel_size)
        model = Model((2 * model.points).astype(np.float32), radii, model.densities,
                      model.norm_den)
    return p, np.asarray(ang, np.float32), quat, model


def prologue_inputs(dev, case: str = "production") -> dict:
    """G3's inputs for one orientation block of the production problem's
    model (``problem.build_problem``), laid out as the engine's banks hold
    it: ``production``, block 0 of its quaternion grid (O = 8); ``euler``,
    a middle block of an Euler grid (36 × 18 × 36 angles, O = 8);
    ``o_block 16``, block 1 of the quaternion grid at O = 16; ``reference
    grid``, block 0 of the reference grid's 4608 quaternions
    (``problem.REFERENCE_GRID``); ``out of frame``, block 0 with the
    model's points spread twice as far and every other point's radius set
    below the pixel size (point-like), so that points leave the frame in
    both branches of the snap. Returns {"fspec", "angles", "quat",
    "model": (points, radii, dens, norm_den), "st_re", "st_im", "st_sums",
    "counts"}."""
    from ..core.projection import make_fourier_projection_spec
    from ..ops.project_cuda import counts_tensor

    p, ang, quat, model = _case_block(case)
    fspec, gidx, pmask, st, st_sums = make_fourier_projection_spec(p, model.radii)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    return dict(
        fspec=fspec, angles=t(ang), quat=quat,
        model=(t(model.points[gidx]), t(model.radii[gidx]), t(model.densities[gidx] * pmask),
               torch.tensor(np.float32(model.norm_den), device=dev)),
        st_re=t(st.real.astype(np.float32)), st_im=t(st.imag.astype(np.float32)),
        st_sums=t(st_sums), counts=counts_tensor(fspec.group_counts, torch.device(dev)),
    )


def _pre_floor(points, angles, quat: bool, pix: float, n: int) -> tuple:
    """The plain versions' values x/pix + N/2 + 0.5 and y/pix + N/2 + 0.5
    of every (orientation, point), each (O, P), whose floors are the raw
    pixel positions: the torch ops of core.projection._snap."""
    from ..core.orientations import rotation_matrices
    from ..core.projection import _rotate

    rot = _rotate(points, rotation_matrices(angles, quat))  # (O, P, 3)
    pix32, half = float(np.float32(pix)), float(n) / 2.0
    return tuple(rot[..., c] / pix32 + half + 0.5 for c in (0, 1))


def _near_integer(v: torch.Tensor) -> torch.Tensor:
    """Where ``v`` lies within 2 ulps of an integer."""
    ulp = (torch.nextafter(v.abs(), torch.full_like(v, np.inf)) - v.abs())
    return (v - torch.round(v)).abs() <= 2 * ulp


def prologue_pre_floor(x: dict) -> tuple:
    """:func:`_pre_floor` of one G3 block, each regrouped to (G, O, Pp)."""
    fs = x["fspec"]
    o_n = x["angles"].shape[0]
    return tuple(v.reshape(o_n, fs.n_groups, fs.group_pad).permute(1, 0, 2)
                 for v in _pre_floor(x["model"][0], x["angles"], x["quat"], fs.pixel_size,
                                     fs.n_pixels))


def check_prologue(x: dict) -> dict:
    """G3 against its plain version on the card, on one block of
    :func:`prologue_inputs`. Returns {"slots": G·O·Pp, "differ": slots
    whose i0 or j0 differ, "off_tie": of those, slots whose differing
    coordinate's plain pre-floor value lies more than 2 ulps from an
    integer (:func:`prologue_pre_floor`), "dens_off": slots with equal
    snaps and unequal densities, "scale_rel": max relative |Δscale| over
    the orientations whose densities all agree, "scale_rel_own": max
    relative |Δ| from norm_den/tempden in torch on G3's own densities,
    "scale_abs": the max |Δscale| there, "bits": two launches give the same
    bits, "dropped": {"point", "sphere"}: slots of model points G3 masked
    out of the frame, by branch}."""
    from ..ops.project_cuda import project_prologue, project_prologue_plain

    args = (x["fspec"], x["angles"], *x["model"], x["st_sums"])
    kern = project_prologue(*args, use_quaternions=x["quat"])
    again = project_prologue(*args, use_quaternions=x["quat"])
    plain = project_prologue_plain(*args, use_quaternions=x["quat"])
    vx, vy = prologue_pre_floor(x)
    torch.cuda.synchronize()
    near = _near_integer
    di, dj = kern[0] != plain[0], kern[1] != plain[1]
    same = ~(di | dj)
    dens_eq = kern[2] == plain[2]
    o_ok = dens_eq.all(dim=2).all(dim=0)
    rel = ((kern[3] - plain[3]).abs() / plain[3].abs())
    own = x["model"][3] / torch.matmul(kern[2].sum(dim=2).T, x["st_sums"])
    # slots of model points whose density G3 masked (out of the frame), by branch
    g_n = kern[0].shape[0]
    dropped = (kern[2] == 0) & (x["model"][2] != 0).reshape(g_n, 1, -1)
    small = (x["model"][1] <= float(np.float32(x["fspec"].pixel_size))).reshape(g_n, 1, -1)
    return dict(
        slots=kern[0].numel(), differ=int((~same).sum()),
        off_tie=int(((di & ~near(vx)) | (dj & ~near(vy))).sum()),
        dens_off=int((same & ~dens_eq).sum()),
        scale_rel=float(rel[o_ok].max()) if bool(o_ok.any()) else 0.0,
        scale_rel_own=float(((kern[3] - own).abs() / own.abs()).max()),
        scale_abs=float((kern[3] - plain[3]).abs()[o_ok].max()) if bool(o_ok.any()) else 0.0,
        bits=all(torch.equal(a, b) for a, b in zip(kern, again)),
        dropped={k: int((dropped & m).sum()) for k, m in (("point", small), ("sphere", ~small))},
    )


def prologue_replay(dev) -> tuple:
    """G3 and K2 (with G3's scale) captured in one CUDA graph on a static
    angle block (:func:`prologue_inputs`' production case, the model read
    from its tensors as the engine's graph reads its banks), replayed
    twice, each time on another block's angle rows copied in (blocks 0
    and 1 of the quaternion grid); and the same two blocks called
    eagerly. Returns (replayed spectra, eager spectra): two lists of
    (re, im)."""
    from ..ops.project_cuda import fourier_project_block, project_prologue

    x = prologue_inputs(dev)
    other = prologue_inputs(dev, "o_block 16")["angles"][:8]  # rows 16..23 of the grid
    blocks = [x["angles"].clone(), other.clone()]
    static = blocks[0].clone()

    def step(angles):
        i0, j0, de, scale = project_prologue(x["fspec"], angles, *x["model"], x["st_sums"],
                                             use_quaternions=True)
        return fourier_project_block(i0, j0, de, x["st_re"], x["st_im"],
                                     n=x["fspec"].n_pixels, counts=x["counts"], scale=scale)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(static)  # warm-up, as the engine's capture does
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = step(static)
    replayed = []
    for a in blocks:
        static.copy_(a)
        graph.replay()
        replayed.append(tuple(v.clone() for v in out))
    eager = [step(a) for a in blocks]
    torch.cuda.synchronize(dev)
    return replayed, eager


def raster_inputs(dev, case: str = "production") -> dict:
    """G4's inputs for one block of :func:`prologue_inputs`' cases, the
    model laid out as the engine's banks hold it on the raster (as read,
    stencil_half from its radii). Returns {"spec", "angles", "quat",
    "model": (points, radii, dens, norm_den)}."""
    from ..core.projection import make_projection_spec

    p, ang, quat, model = _case_block(case)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    return dict(spec=make_projection_spec(p, model.radii), angles=t(ang), quat=quat,
                model=(t(model.points), t(model.radii), t(model.densities),
                       torch.tensor(np.float32(model.norm_den), device=dev)))


def check_raster(x: dict, orients=None, lattice: bool = False) -> dict:
    """G4 against its plain version on the card, on one block of
    :func:`raster_inputs` (or :func:`map_inputs`; ``lattice``: its lattice
    variant, whose snaps are compared where either side's lies in the
    frame, the variant writing no other). G4 runs the whole block;
    ``orients``, a list of the block's rows, limits the comparison with the
    plain version to those rows (the plain version of a 224³ map holds
    ~2 GB a row in each of its weight tensors). Returns {"pairs": O·P of
    the rows compared, "compared": the rows compared whose snaps all agree,
    "differ": (orientation,
    point) pairs whose snapped pixel differs, "off_tie": of those, pairs
    whose differing coordinate's plain pre-floor value lies more than 2
    ulps from an integer, "proj_rel": max |Δ| of the projections over the
    plain version's max |pixel|, on the orientations whose snaps all agree
    (a snap moved at a tie moves a whole density), "proj_abs": that max
    |Δ| itself, "scale_rel": max
    relative |Δ| of norm_den/tempden there, "bits": two launches give the same bits (projection, snaps, scale),
    "dropped": {"point", "sphere"}: pairs of nonzero density the plain
    version masked out of the frame, by branch, "live": pairs that deposit
    (in the frame, nonzero density: raster_bound's count), "reorder_ok":
    on those orientations every pixel within f32 reordering's bound of the
    plain version's (2(c − 1)·u·Σ|w| for its c weights, and the scales'
    roundings and difference)}."""
    from ..core.orientations import rotation_matrices
    from ..core.projection import _raster_scatter, _snap, _stencil_weights
    from ..ops.project_cuda import raster_project, raster_project_plain

    spec, quat = x["spec"], x["quat"]
    pts, radii, dens, norm_den = x["model"]
    o_all, p_n = x["angles"].shape[0], pts.shape[0]

    def kern():
        snaps = torch.full((o_all, 2, p_n), UNWRITTEN, dtype=torch.int32, device=pts.device)
        scale = torch.empty((o_all,), dtype=torch.float32, device=pts.device)
        out = raster_project(spec, x["angles"], *x["model"], use_quaternions=quat, snaps=snaps,
                             scale=scale, lattice=x["lattice"] if lattice else None)
        return out, snaps, scale

    k, again = kern(), kern()
    bits = all(torch.equal(a, b) for a, b in zip(k, again))
    del again
    rows = list(range(o_all)) if orients is None else list(orients)
    sel = torch.as_tensor(rows, device=pts.device)
    ang, o_n = x["angles"][sel], len(rows)
    k = tuple(v[sel] for v in k)
    plain = raster_project_plain(spec, ang, *x["model"], use_quaternions=quat)
    rotm = rotation_matrices(ang, quat)
    i0, j0, small, valid = _snap(spec.n_pixels, spec.pixel_size, spec.shift_x, spec.shift_y,
                                 rotm, pts, radii)
    _i, _j, w, du = _stencil_weights(spec, rotm, pts, radii, dens)
    scale_p = norm_den / torch.sum(w, dim=(-3, -2, -1))
    # f32 reordering's bound at each pixel: two orders of a sum of c terms
    # differ by at most 2(c − 1)·u·Σ|term|, then each scale's rounding and
    # the two scales' difference
    u = 2.0 ** -24
    terms = _raster_scatter(spec, _i, _j, (w != 0).to(w.dtype), du)
    mass = _raster_scatter(spec, _i, _j, w.abs(), du)
    unscaled = plain / scale_p[:, None, None]
    bound = ((2.0 * (terms - 1).clamp(min=0) * u * mass + u * unscaled.abs())
             * k[2].abs()[:, None, None] + unscaled.abs() * (k[2] - scale_p).abs()[:, None, None]
             + u * plain.abs())
    vx, vy = _pre_floor(pts, ang, quat, spec.pixel_size, spec.n_pixels)
    torch.cuda.synchronize()
    n = spec.n_pixels
    seen = ((i0 >= 0) & (j0 >= 0) & (i0 < n) & (j0 < n)) | (k[1][:, 0] != UNWRITTEN)
    di, dj = seen & (k[1][:, 0] != i0), seen & (k[1][:, 1] != j0)
    o_ok = ~(di | dj).any(dim=1)
    dropped = ~valid & (dens != 0)
    peak = float(plain.abs().max())
    rel = (k[2] - scale_p).abs() / scale_p.abs()
    over = ((k[0] - plain).abs() - bound)[o_ok]
    return dict(
        reorder_ok=bool((over <= 0).all()),
        pairs=o_n * p_n, compared=int(o_ok.sum()), differ=int((di | dj).sum()),
        off_tie=int(((di & ~_near_integer(vx)) | (dj & ~_near_integer(vy))).sum()),
        proj_abs=float((k[0] - plain).abs()[o_ok].max()) if bool(o_ok.any()) else 0.0,
        proj_rel=float((k[0] - plain).abs()[o_ok].max()) / peak if bool(o_ok.any()) else 0.0,
        scale_rel=float(rel[o_ok].max()) if bool(o_ok.any()) else 0.0,
        bits=bits,
        dropped={key: int((dropped & m).sum()) for key, m in (("point", small),
                                                               ("sphere", ~small))},
        live=int((valid & (dens != 0) & (small | (spec.stencil_half > 0))).sum()),
    )


# The snaps a check's G4 leaves unwritten (the lattice variant writes those
# of the voxels whose snap lies in the frame).
UNWRITTEN = -(2 ** 31)


def check_raster_lattice(x: dict, orients=None) -> dict:
    """G4's lattice variant on one block of :func:`map_inputs`: against the
    plain version as :func:`check_raster` holds G4 (its keys), and against
    the generic variant on the same block: "snaps_equal", every snap the
    lattice variant wrote equal to the generic variant's and every snap of
    the generic variant's in the frame written; "scale_ulps", the scales'
    largest distance in f32 ulps."""
    from ..ops.project_cuda import raster_project

    r = check_raster(x, orients, lattice=True)
    o_n, p_n = x["angles"].shape[0], x["model"][0].shape[0]
    dev = x["model"][0].device
    snaps = {}
    scale = {}
    for name, lat in (("lattice", x["lattice"]), ("generic", None)):
        snaps[name] = torch.full((o_n, 2, p_n), UNWRITTEN, dtype=torch.int32, device=dev)
        scale[name] = torch.empty((o_n,), dtype=torch.float32, device=dev)
        raster_project(x["spec"], x["angles"], *x["model"], use_quaternions=x["quat"],
                       snaps=snaps[name], scale=scale[name], lattice=lat)
    n = x["spec"].n_pixels
    g, lt = snaps["generic"], snaps["lattice"]
    in_frame = ((g >= 0) & (g < n)).all(dim=1)
    wrote = (lt != UNWRITTEN).all(dim=1)
    both = wrote[:, None, :].expand_as(lt)
    r.update(snaps_equal=bool(torch.equal(wrote, in_frame) and torch.equal(lt[both], g[both])),
             scale_ulps=ulp_distance(scale["lattice"], scale["generic"]),
             in_frame=int(in_frame.sum()))
    return r


def raster_times(x: dict) -> dict:
    """The card's own time (:func:`device_ms`) of G4, its plain version and
    cuFFT's rfft2 of G4's output (the transform it feeds) on one block of
    :func:`raster_inputs`: {"ms", "plain_ms", "rfft2_ms"}."""
    from ..ops.project_cuda import raster_project, raster_project_plain

    args = (x["spec"], x["angles"], *x["model"])
    out = raster_project(*args, use_quaternions=x["quat"])
    return dict(ms=device_ms(lambda: raster_project(*args, use_quaternions=x["quat"])),
                plain_ms=device_ms(lambda: raster_project_plain(
                    *args, use_quaternions=x["quat"]), 5),
                rfft2_ms=device_ms(lambda: torch.fft.rfft2(out)))


def synthetic_map(box, pix: float, seed: int = 5, noise: float = 0.05):
    """A ``box``³ voxel map (``box`` an int, or (nx, ny, nz)) read as
    --ReadModelMRC reads it (io.model_io.voxel_model) and centred on its
    density mass: 24 Gaussian blobs of 2–6 Å within the middle half of the
    box, plus N(0, ``noise`` × the blobs' peak) on every voxel, so that no
    voxel is zero and the corners leave the frame."""
    from ..io.model_io import voxel_model

    shape = (box,) * 3 if np.isscalar(box) else tuple(box)
    rng = np.random.default_rng(seed)
    axes = [(np.arange(1, n + 1) - n / 2.0) * pix for n in shape]
    vol = np.zeros(shape, np.float64)
    half = min(shape) * pix / 4.0
    for c, s, a in zip(rng.uniform(-half, half, (24, 3)), rng.uniform(2.0, 6.0, 24),
                       rng.uniform(50.0, 100.0, 24)):
        g = [np.exp(-((axes[k] - c[k]) ** 2) / (2.0 * s * s)) for k in range(3)]
        vol += a * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    vol += rng.normal(0.0, noise * vol.max(), vol.shape)
    return voxel_model(vol.astype(np.float32), pix).center_density_mass()


def lattice_angles(n_random: int = 4, seed: int = 7) -> np.ndarray:
    """Quaternion rows (x, y, z, w) for the lattice kernel's checks: the
    identity and 90° about z (axis-aligned views), 45° about x, y and z,
    a third of a turn about (1, 1, 1) (a view down a body diagonal, where
    the plane axis is a three-way tie), then ``n_random`` random rotations
    each followed by its −q (the same rotation)."""
    def about(axis, deg):
        axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
        h = np.radians(deg) / 2.0
        return np.concatenate([axis * np.sin(h), [np.cos(h)]])

    rows = [about((0, 0, 1), 0.0), about((0, 0, 1), 90.0), about((1, 0, 0), 45.0),
            about((0, 1, 0), 45.0), about((0, 0, 1), 45.0), about((1, 1, 1), 120.0)]
    rng = np.random.default_rng(seed)
    for q in rng.normal(size=(n_random, 4)):
        q /= np.linalg.norm(q)
        rows += [q, -q]
    return np.asarray(rows, np.float32)


def map_inputs(dev, box=224, n_orient: int = 8, seed: int = 5, *, angles=None,
               shift=(0, 0)) -> dict:
    """G4's inputs for one block of :func:`synthetic_map`'s map (``box``: an
    int for a cube, or (nx, ny, nz)) at N = its largest side, on the
    reference grid's first ``n_orient`` quaternions or the rows ``angles``,
    with the model's (shift_x, shift_y) (the form of :func:`raster_inputs`):
    the map's one radius 2·pix gives stencil_half 3 and 9 weights a voxel.
    "lattice" holds what the engine hands G4's lattice variant: (the axes
    on the card, the shape, the radius)."""
    import dataclasses

    from ..core.projection import lattice_axes, lattice_field, make_projection_spec
    from ..utils.so3 import super_fibonacci
    from .problem import REFERENCE_GRID

    shape = (box,) * 3 if np.isscalar(box) else tuple(box)
    p, _ang, _quat, _model = _case_block("reference grid")
    p = dataclasses.replace(p, n_pixels=max(shape), shift_x=shift[0], shift_y=shift[1])
    model = synthetic_map(shape, p.pixel_size, seed)
    if angles is None:
        angles = super_fibonacci(REFERENCE_GRID["n_orient"])[:n_orient]
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    axes, found = lattice_axes(model.points, model.radii, p.pixel_size)
    return dict(spec=make_projection_spec(p, model.radii), angles=t(np.float32(angles)),
                quat=True, p=p,
                model=(t(model.points), t(model.radii), t(model.densities),
                       torch.tensor(np.float32(model.norm_den), device=dev)), host=model,
                lattice=(t(lattice_field(axes, model.densities)), found,
                         float(model.radii[0])))


def check_raster_sparse(dev, wide: bool = False) -> dict:
    """G4's weights and snaps against the plain version's, bit for bit: a
    sheet of points 10 pixels apart in the z = 0 plane, with radii from
    point-like to 3.4 pixels, at 8 rotations about z (the sheet stays in
    the frame's plane, so no two stencils meet and every pixel holds one
    weight). ``wide``: a 3 × 3 sheet 66 pixels apart with radii from
    point-like to 31.5 pixels, whose reach bound (31) leaves the deposit's
    octant table out of shared memory, so each lane forms its pixels'
    weights. The kernel's projection must equal the plain version's
    weights, deposited with index_add_ (one per pixel: exact), times the
    kernel's own scale; and its snaps the plain version's. Returns
    {"pairs", "stencil_half", "snaps_equal", "weights_equal",
    "scale_rel"}."""
    import dataclasses

    from ..core.orientations import rotation_matrices
    from ..core.projection import _raster_scatter, _stencil_weights, make_projection_spec
    from ..ops.project_cuda import raster_project

    p, _ang, _quat, _model = _case_block("reference grid")
    p = dataclasses.replace(p, n_pixels=224)
    pix = np.float32(p.pixel_size)
    rng = np.random.default_rng(11)
    if wide:  # the corners point-like: rotated, a sphere there would leave the frame
        g = np.arange(-1, 2) * 66.0 * float(pix) + 0.31
        radii = np.array([0.5, 28.5, 0.5, 30.0, 31.5, 3.4, 0.5, 29.0, 0.5], np.float32) * pix
    else:
        g = np.arange(-9, 10) * 10.0 * float(pix) + 0.31
        radii = rng.choice(np.array([0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.4], np.float32) * pix,
                           g.size ** 2)
    radii = radii.astype(np.float32)
    xy = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts = np.concatenate([xy, np.zeros((xy.shape[0], 1))], 1).astype(np.float32)
    dens = rng.uniform(-5.0, 100.0, pts.shape[0]).astype(np.float32)
    theta = np.linspace(0.0, np.pi / 3, 8)
    ang = np.stack([np.zeros(8), np.zeros(8), np.sin(theta / 2), np.cos(theta / 2)],
                   1).astype(np.float32)
    spec = make_projection_spec(p, radii)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    model = (t(pts), t(radii), t(dens), torch.tensor(np.float32(dens.sum()), device=dev))
    snaps = torch.empty((8, 2, pts.shape[0]), dtype=torch.int32, device=dev)
    scale = torch.empty((8,), dtype=torch.float32, device=dev)
    out = raster_project(spec, t(ang), *model, use_quaternions=True, snaps=snaps, scale=scale)
    rotm = rotation_matrices(t(ang), True)
    i0, j0, w, du = _stencil_weights(spec, rotm, *model[:3])
    plain = _raster_scatter(spec, i0, j0, w, du) * scale[:, None, None]
    scale_p = model[3] / torch.sum(w, dim=(-3, -2, -1))
    torch.cuda.synchronize()
    return dict(pairs=8 * pts.shape[0], stencil_half=spec.stencil_half,
                snaps_equal=bool(torch.equal(snaps[:, 0], i0) and torch.equal(snaps[:, 1], j0)),
                weights_equal=bool(torch.equal(out, plain)),
                scale_rel=float(((scale - scale_p).abs() / scale_p.abs()).max()))


def raster_map_block(dev, box: int = 224, reps: int = 3, plain: bool = False) -> dict:
    """G4 on one block (8 orientations) of the ``box``³ map
    (:func:`map_inputs`), each variant in turn in one process: two launches
    bit-equal, every pixel finite, each projection's sum against norm_den
    (the scale makes them equal but for the f32 sums), and its card time.
    Returns {"generic", "lattice": {"bits", "finite", "sum_rel", "ms",
    "split": ms of each of its kernels (torch.profiler), "kernels": its
    kernel launches a call, "calls": raster_project.launches over the
    calls, "across": {block: ms} at every 64th block of the reference
    grid's list}, "rfft2_ms", "points", "plain_row_ms": with ``plain``, the
    plain version's card time for one orientation of the block}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.project_cuda import raster_project, raster_project_plain
    from ..utils.so3 import super_fibonacci
    from .problem import REFERENCE_GRID

    x = map_inputs(dev, box)
    args = (x["spec"], x["angles"], *x["model"])
    nd = float(x["model"][3])
    q = super_fibonacci(REFERENCE_GRID["n_orient"]).astype(np.float32)
    res = dict(points=int(x["model"][0].shape[0]))
    for name, lat in (("generic", None), ("lattice", x["lattice"])):
        def call(angles=x["angles"], lat=lat):
            return raster_project(x["spec"], angles, *x["model"], use_quaternions=True,
                                  lattice=lat)

        before = raster_project.launches
        a, b = call(), call()
        sums = a.double().sum(dim=(1, 2))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        split, kernels = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "raster_projection_kernel" in e.name:
                key = e.name.split("raster_projection_kernel_")[1].split("(")[0].split("<")[0]
                split[key] = (split.get(key, 0.0)
                              + (e.time_range.end - e.time_range.start) * 1e-3 / reps)
                kernels += 1
        # the card time of blocks across the orientation list (the
        # orientation moves the work: the generic variant's bins, the
        # lattice variant's plane axis and windows)
        across = {}
        for blk in range(0, q.shape[0] // 8, 64):
            ab = torch.as_tensor(q[8 * blk: 8 * blk + 8], device=dev)
            across[blk] = device_ms(lambda ab=ab: call(ab), 1)
        res[name] = dict(split=split, kernels=kernels // reps, across=across,
                         bits=bool(torch.equal(a, b)), finite=bool(torch.isfinite(a).all()),
                         sum_rel=float(((sums - nd).abs() / abs(nd)).max()),
                         ms=device_ms(call, reps), calls=raster_project.launches - before)
        res["rfft2_ms"] = device_ms(lambda: torch.fft.rfft2(a), reps)
        del a, b
    if plain:
        row = x["angles"][:1]
        res["plain_row_ms"] = device_ms(lambda: raster_project_plain(
            x["spec"], row, *x["model"], use_quaternions=True), 1)
    return res


def near_ties(n: int, pix: float, points: np.ndarray, angles: np.ndarray, quat: bool) -> int:
    """(orientation, point) pairs whose snap coordinate x/pix + N/2 + 0.5
    lies within 2 float32 ulps of an integer on either axis, in f64 from
    torch's rotation matrices of ``angles``: where two orders of the
    rotation's float32 sums may snap a pixel apart."""
    from ..core.orientations import rotation_matrices

    rot = rotation_matrices(torch.as_tensor(np.asarray(angles, np.float32)), quat).double()
    pts = torch.as_tensor(np.asarray(points, np.float64))
    ties = 0
    for r in rot:
        v = (pts @ r[:2].T) / float(np.float32(pix)) + n / 2.0 + 0.5
        ulp = torch.as_tensor(np.spacing(np.abs(v.numpy()).astype(np.float32)).astype(np.float64))
        ties += int(((v - torch.round(v)).abs() <= 2 * ulp).any(dim=1).sum())
    return ties


def check_census(dev, box: int = 32, stride: int = 1) -> dict:
    """The card's out-of-frame census (core.projection.oob_census on the
    card) of :func:`synthetic_map`'s ``box``³ map at N = ``box`` against
    projection_oob_report on the host, over every ``stride``-th orientation
    of the reference grid's list (box 32: its first 64). Returns {"card",
    "host": (dropped pairs, orientations affected, orientations all out),
    "ties": :func:`near_ties` of the map's points that can leave the frame,
    "orients", "points"}: the card's count may differ from the host's only
    at ties."""
    from ..core.orientations import rotation_matrices
    from ..core.projection import oob_census, projection_oob_report
    from ..utils.so3 import super_fibonacci
    from .problem import REFERENCE_GRID

    pix = 1.06
    m = synthetic_map(box, pix)
    q = super_fibonacci(64 if box == 32 else REFERENCE_GRID["n_orient"])
    ang = np.ascontiguousarray(q[::stride], dtype=np.float32)
    rot = rotation_matrices(torch.as_tensor(ang), True).numpy()
    host = projection_oob_report(box, pix, 0, 0, m.points, m.radii, rot)
    card = oob_census(box, pix, 0, 0, m.points, m.radii, ang, True, device=dev)
    r3d = np.linalg.norm(m.points.astype(np.float64), axis=1)
    irad = np.where(m.radii > pix, (m.radii / np.float32(pix)).astype(np.int64) + 1, 0)
    edge = ~((r3d / pix + 0.5 + irad) < (box / 2.0 - 1.0))
    return dict(card=card, host=host, ties=near_ties(box, pix, m.points[edge], ang, True),
                orients=int(ang.shape[0]), points=int(m.points.shape[0]))


def path_rule_times(dev, sizes=(500, 5000, 50000, 500000, 224 ** 3), reps: int = 3,
                    say=print) -> list:
    """The card's own time (:func:`device_ms`) of each projection path per
    block of 8 orientations of the reference grid at N = 224: G3 + K2
    (the Fourier path) and G4 + rfft2 (the raster), for the reference
    grid's 500-residue model (14 radii) and for the first P voxels of
    :func:`synthetic_map`'s 224³ map (one radius, 2·pix) at each P of
    ``sizes``. Returns [{"model", "points", "groups", "slots", "fourier_ms",
    "raster_ms"}]: the path rule's constants (core/projection.py) are
    fitted to them."""
    from ..core.projection import (make_fourier_projection_spec, make_projection_spec,
                                   project_batch_kernel, project_fourier_batch_kernel)
    from ..io.model_io import Model

    x = map_inputs(dev, 224)
    p, ang, full = x["p"], x["angles"], x["host"]
    _p, _a, _q, residues = _case_block("reference grid")
    rows = []
    for label, m in [("500 residues", residues)] + [
            (f"{n} voxels", Model(full.points[:n], full.radii[:n], full.densities[:n],
                                  float(full.densities[:n].astype(np.float64).sum())))
            for n in sizes]:
        t = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=dev)  # noqa: E731
        nd = torch.tensor(np.float32(m.norm_den), device=dev)
        fspec, gidx, pmask, st, sums = make_fourier_projection_spec(p, m.radii)
        fargs = (fspec, ang, t(m.points[gidx]), t(m.radii[gidx]), t(m.densities[gidx] * pmask),
                 nd, t(st.real), t(st.imag), t(sums))
        spec = make_projection_spec(p, m.radii)
        rargs = (spec, ang, t(m.points), t(m.radii), t(m.densities), nd)
        big = m.points.shape[0] > 1_000_000
        f_ms = device_ms(lambda: project_fourier_batch_kernel(*fargs, use_quaternions=True),
                         1 if big else reps)
        r_ms = device_ms(lambda: torch.fft.rfft2(project_batch_kernel(*rargs,
                                                                      use_quaternions=True)),
                         reps)
        rows.append(dict(model=label, points=int(m.points.shape[0]), groups=fspec.n_groups,
                         slots=fspec.n_groups * fspec.group_pad, fourier_ms=f_ms, raster_ms=r_ms))
        say(f"path rule, N = 224, a block of 8 orientations (card time): {label}: G3 + K2 "
            f"{f_ms:.4f} ms ({fspec.n_groups} groups x {fspec.group_pad} slots), G4 + rfft2 "
            f"{r_ms:.4f} ms")
        del fargs, rargs
        torch.cuda.empty_cache()
    return rows


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


def probe_body_ablation(say=print, img_tile: int = 8, block: str = "production") -> dict:
    """P3 on a block of :data:`BLOCKS` (K1 alone at the reference block,
    where K4 has no instance). Returns {"ms": {(body, variant): ms},
    "bit_equal": {body: bool}, "comparisons": n, "dims": the block's (O, C,
    I, N, F, D, M, n_fold), "max_abs_err": max |Δm| of the last body's full
    variant from the plain version, "plain_ms": the plain version's time}."""
    dev = _require_card()
    args, a_coef, n_fold = block_inputs(dev, *BLOCKS[block])
    (o, n, f), c, i, (d, m) = args[0].shape, args[2].shape[0], args[4].shape[0], args[6].shape
    n_cmp = o * c * i
    bodies = ("k1", "k4") if d <= 32 else ("k1",)
    prod = {"k1": compare_cuda.fused_compare_block(*args, a_coef=a_coef, n_fold=n_fold)}
    if "k4" in bodies:
        prod["k4"] = compare_cuda.fused_compare_block_batched(*args, a_coef=a_coef,
                                                              n_fold=n_fold, img_tile=img_tile)
    plain = compare_cuda.fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    out = {"ms": {}, "bit_equal": {}, "comparisons": n_cmp,
           "dims": (o, c, i, n, f, d, m, n_fold),
           "max_abs_err": float((prod[bodies[-1]][0] - plain[0]).abs().max()),
           "plain_ms": time_ms(lambda: compare_cuda.fused_compare_block_plain(
               *args, a_coef=a_coef, n_fold=n_fold), 3)}
    for body in bodies:
        for variant in probe_cuda.BODY_VARIANTS[body]:
            if variant == "no_stage2" and compare_cuda.k1_rows(d, 2) != (1, 88):
                continue  # K1's 88-row wide chunk only (D = 65..88)
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
                f"{t:.4f} ms per {block} block ({t * 1e6 / n_cmp:.1f} ns per comparison){note}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = _require_card()
    print(f"card: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if "--p3" in argv:
        probe_body_ablation(block=argv[argv.index("--p3") + 1])
        return 0
    for shape in ((8, 8, 64), (16, 8, 64), (8, 32, 64)):
        x = glue_inputs(dev, *shape)
        for label, ms in glue_attribution(x["g1"], x["kw"], glue_merge_args(x, "fused")).items():
            print(f"glue at (O, C, I) = {shape} (card time): {label} {ms:.5f} ms", flush=True)
    if "--glue" in argv:
        return 0
    if "--raster" in argv:
        r = check_raster_sparse(dev)
        print(f"G4 sparse sheet: snaps equal {r['snaps_equal']}, weights bit-equal "
              f"{r['weights_equal']}, scale max rel |Δ| {r['scale_rel']:.2e}", flush=True)
        m = raster_map_block(dev, plain=True)
        for name in ("generic", "lattice"):
            v = m[name]
            print(f"G4 {name} at a block of the 224³ map ({m['points']} voxels, 8 orientations, "
                  f"card time): {v['ms']:.3f} ms, {v['kernels']} kernel launches a call "
                  f"({v['calls']} calls counted), rfft2 {m['rfft2_ms']:.4f} ms; two launches "
                  f"bit-equal {v['bits']}, finite {v['finite']}, sum vs norm_den "
                  f"{v['sum_rel']:.2e}; by kernel (profiler) "
                  + ", ".join(f"{k} {t:.3f} ms" for k, t in v["split"].items())
                  + "; at blocks " + ", ".join(f"{k}: {t:.3f}" for k, t in v["across"].items())
                  + f" ms (mean {np.mean(list(v['across'].values())):.3f})", flush=True)
        print(f"G4's plain version at one orientation of that block: {m['plain_row_ms']:.2f} ms",
              flush=True)
        print(json.dumps({"path_rule": path_rule_times(dev)}), flush=True)
        return 0
    probe_f32_accuracy()
    probe_issue_overhead()
    probe_body_ablation()
    probe_projection_points()
    t = raster_times(raster_inputs(dev))
    print(f"G4 at the production raster block (card time): {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, cuFFT's rfft2 of its output {t['rfft2_ms']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
