"""Device time of the whole comparison pipeline, per design, on one block.

The port's counterpart of the JAX package's ``tools/pipeline_lab.py``:
``profile_block`` times the comparison kernel alone; this times each
pipeline from the projection spectra to the displacement log-sum-exp
summary (conv, cc, log-sum-exp and their constants), so that designs which
move work between a kernel and torch are compared fairly:

* ``fused``: the convolution sums and f64 constants in torch, K1 (conv, cc
  and the log-sum-exp in one kernel), the f64 repair of the max;
* ``batched``: the same with K4, the image-batched kernel, at the engine's
  image tile;
* ``hybrid``: conv and its sums in torch, K3 (the cc lattice), then the
  torch ``displacement_lse``.

Every pipeline runs on block 0 of the production problem
(``tools/problem.py``), ``reps`` times after a warm-up, under
``torch.profiler``: the device time per step is the sum of its kernels'
times; the CUDA-event time per step (host launch gaps included) is given
beside it. On the CPU (``BIOEM_TPU_FORCE_CPU=1``, at a caller's size) the
kernel wrappers run their plain versions and only the host time is given.

    python -m bioem_tpu_torch.tools.pipeline_lab [fused hybrid batched]
"""

from __future__ import annotations

import sys
import time

import torch

PIPELINES = ("fused", "batched", "hybrid")


def steps(eng) -> dict:
    """{pipeline: step()} on block 0 of ``eng``'s banks."""
    from ..core.engine import fused_coefficients
    from ..core.posterior import (convolution_sums, displacement_lse, logpro_constants,
                                  refine_varying_max)
    from ..ops import compare_cuda

    bk, p = eng.banks, eng.p
    o, c, n, f = eng.o_block, eng.n_ctf, p.n_pixels, p.n_fft_1d
    i_n, d, ntot = bk.img_re.shape[0], eng.disp.shape[0], p.n_total_pixels
    m_cols = n // eng.n_fold
    wx = (bk.wx_re[:, :m_cols].contiguous(), bk.wx_im[:, :m_cols].contiguous())
    prior = eng._prior[None, :].expand(o, c)
    pr, pi = eng._project_block(bk, eng.ang_blocks[0])
    a_coef = (3.0 - ntot) * 0.5

    def fused_with(kernel, **kw):
        def step():
            sum_c, _ssq_c, f0, k = eng._kernel_constants(bk, pr, pi, prior)
            a_u, b_u = fused_coefficients(f0, sum_c, bk.sum_ref, ntot)
            _m, se, ds, ccs = kernel(pr, pi, bk.ctf_re, bk.ctf_im, bk.img_re, bk.img_im, *wx,
                                     bk.wy_re, bk.wy_im, a_u, b_u, a_coef=a_coef,
                                     n_fold=eng.n_fold, **kw)
            ccs = ccs.reshape(o, c, i_n)
            return refine_varying_max(ccs, sum_c, bk.sum_ref, f0, ntot), se, ds, ccs, k
        return step

    def hybrid():
        conv_re = pr[:, None] * bk.ctf_re[None] + pi[:, None] * bk.ctf_im[None]
        conv_im = pi[:, None] * bk.ctf_re[None] - pr[:, None] * bk.ctf_im[None]
        sum_c, ssq_c = convolution_sums(conv_re, conv_im, bk.h, n)
        f0, k = logpro_constants(sum_c, ssq_c, bk.sum_ref, bk.ssq_ref, prior, ntot,
                                 images_normalized=eng._f32_corr_ok)
        cc = compare_cuda.fused_displacement_cc(
            conv_re.reshape(o * c, n, f), conv_im.reshape(o * c, n, f), bk.img_re, bk.img_im,
            *wx, bk.wy_re, bk.wy_im, n_fold=eng.n_fold).reshape(o, c, i_n, d, d)
        return (*displacement_lse(cc, sum_c, bk.sum_ref, f0, ntot, f32_u=eng._f32_corr_ok,
                                  ssq_c=ssq_c, ssq_ref=bk.ssq_ref), k)

    return {"fused": fused_with(compare_cuda.fused_compare_block),
            "batched": fused_with(compare_cuda.fused_compare_block_batched,
                                  img_tile=eng.i_block),
            "hybrid": hybrid}


def step_ms(step, dev, reps: int = 20) -> dict:
    """{"device_ms": kernels' time per step (card only), "event_ms": CUDA
    events per step (card) or "host_ms" (CPU)}."""
    step()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        return {"host_ms": (time.perf_counter() - t0) * 1e3 / reps}
    from torch.profiler import ProfilerActivity, profile

    from .trace_step import _device_us, device_kernels

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            step()
        stop.record()
        torch.cuda.synchronize(dev)
    dev_us = sum(_device_us(e) for e in device_kernels(prof.key_averages()))
    return {"device_ms": dev_us * 1e-3 / reps, "event_ms": start.elapsed_time(stop) / reps}


def lab(eng, names=PIPELINES, reps: int = 20) -> dict:
    """{pipeline: step_ms(...) and comparisons_per_s} on ``eng``'s block 0."""
    comparisons = eng.o_block * eng.n_ctf * eng.banks.img_re.shape[0]
    run = steps(eng)
    out = {}
    for name in names:
        t = step_ms(run[name], eng.device, reps)
        ms = t.get("device_ms", t.get("host_ms"))
        out[name] = {**t, "comparisons_per_s": comparisons / (ms * 1e-3)}
    return out


def main(argv=None) -> int:
    from .profile_block import engine_for

    args = (sys.argv[1:] if argv is None else argv) or list(PIPELINES)
    eng = engine_for()
    for name, r in lab(eng, args).items():
        times = ", ".join(f"{k} {v:.4f}" for k, v in r.items() if k.endswith("_ms"))
        print(f"{name}: {times} ms/step = {r['comparisons_per_s']:,.0f} comparisons/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
