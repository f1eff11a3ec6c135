"""Where one orientation block's time goes, phase by phase.

The port's counterpart of the JAX package's ``tools/profile_block.py``. On
the production problem (``tools/problem.py``) it times one block of the
engine's kernel branch, and each phase of it alone on the same inputs:

* ``step``: the whole block step, as the pass runs it (one replay of the
  captured CUDA graph on the card; the eager step on the CPU);
* ``projection``: G3 (rotations, snap, masks and the scale) and K2, or on
  the raster (``--projection raster``) G4 and torch.fft.rfft2
  (``_project_block``);
* ``constants``: G1, the convolution sums, the f64 constants and the u
  coefficients (``_kernel_constants``);
* ``compare``: the comparison: K1, or K4 when the engine runs it
  (``BIOEM_TPU_FUSED_BATCHED=1``), or on the hybrid conv, K3 and the
  torch log-sum-exp;
* ``merge``: G2, the f64 repair of the max and the streaming merge;
* ``residual``: the step less the four phases (launch gaps).

These are the phases of the engine's ``bioem.*`` profiler ranges, which
``trace_step`` groups the glue by. The comparison's operations and bytes
come from
``problem.compare_work`` and ``problem.compare_bytes``, the counts
chip_smoke.py's kernel table uses, beside its achieved rate and bound.

On the card each phase is timed with CUDA events over ``reps`` calls after
a warm-up, queued behind a spin of the card so that the host's launch time
(tens of µs per torch op) does not enter; on the CPU (``BIOEM_TPU_FORCE_CPU=1``, at a size the caller
gives) with the host clock, and the rows say so.

    python -m bioem_tpu_torch.tools.profile_block [reps] [--projection raster]
"""

from __future__ import annotations

import argparse
import sys
import time
from functools import partial

import torch


def time_ms(fn, dev, reps: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` after one warm-up call: on the
    card its own time (``kernel_probe.device_ms``: CUDA events around calls
    queued behind a spin of the card, so the host's launch time does not
    enter), on the CPU the host clock."""
    if dev.type == "cuda":
        from .kernel_probe import device_ms

        return device_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def engine_for(problem=None, cfg=None, device=None, projection: str = "auto"):
    """The single-device engine of ``problem`` (default: the production
    problem) under ``cfg`` (default: the kernel branch, no autotuning, on
    ``projection``: "auto", "fourier" or "raster")."""
    from ..config import RunConfig
    from ..core.engine import BioEMEngine
    from .problem import build_problem

    p, orients, model, images, _ = problem or build_problem()
    cfg = cfg or RunConfig(use_kernels=True, autotune=False, projection=projection)
    return BioEMEngine(p, orients, model, images, cfg, device=device)


def parse_args(argv, count: str, default: int):
    """(``count``, projection) from a tool's command line:
    ``[count] [--projection auto|fourier|raster]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument(count, type=int, nargs="?", default=default)
    ap.add_argument("--projection", choices=("auto", "fourier", "raster"), default="auto")
    args = ap.parse_args(argv)
    return getattr(args, count), args.projection


def profile(eng, reps: int = 10) -> dict:
    """Milliseconds of each phase of block 0 of ``eng`` (which must run its
    kernel branch), the comparison kernel's work, and the device they ran
    on: {"phases": {name: ms}, "compare": {...}, "device", "timer"}."""
    from ..core.posterior import displacement_lse
    from ..ops import compare_cuda, posterior_cuda
    from .golden_error_budget import comparison_of
    from .problem import compare_bound, compare_bytes, compare_work

    if not eng.use_kernels:
        raise ValueError("profile_block times the kernel branch: use_kernels must hold")
    dev, bk, p = eng.device, eng.banks, eng.p
    o, c, n, f = eng.o_block, eng.n_ctf, p.n_pixels, p.n_fft_1d
    i_n, d, ntot = bk.img_re.shape[0], eng.disp.shape[0], p.n_total_pixels
    m_cols = n // eng.n_fold
    ang, mask = eng.ang_blocks[0], eng.mask_blocks[0]
    wx_re, wx_im = eng.wx_cols
    a_coef = (3.0 - ntot) * 0.5
    which = comparison_of(eng)
    ms = {}

    if eng._replayed():
        # ``reps`` replays from block 0 (the graph advances its own index)
        state = eng._graph_load(eng.initial_state(), 0)
        reps_step = min(reps, eng.ang_blocks.shape[0])

        def run_blocks():
            eng._graph_load(state, 0)
            for _ in range(reps_step):
                eng._replay()

        ms["step"] = time_ms(run_blocks, dev, 1) / reps_step
    else:
        state = eng.initial_state()
        ms["step"] = time_ms(lambda: eng._block_step(state, bk, ang, 0, mask), dev, reps)

    pr, pi = eng._project_block(bk, ang)
    ms["projection"] = time_ms(lambda: eng._project_block(bk, ang), dev, reps)
    sum_c, ssq_c, f0, k, a_u, b_u = eng._kernel_constants(bk, pr, pi, mask)

    ms["constants"] = time_ms(lambda: eng._kernel_constants(bk, pr, pi, mask), dev, reps)
    args = (pr, pi, bk.ctf_re, bk.ctf_im, bk.img_re, bk.img_im, wx_re, wx_im, bk.wy_re, bk.wy_im)
    if which in ("K1", "K4"):
        kernel = (compare_cuda.fused_compare_block if which == "K1" else
                  partial(compare_cuda.fused_compare_block_batched, img_tile=eng.i_block))

        def compare():
            return kernel(*args, a_u, b_u, a_coef=a_coef, n_fold=eng.n_fold)
    else:
        def compare():
            conv_re = pr[:, None] * bk.ctf_re[None] + pi[:, None] * bk.ctf_im[None]
            conv_im = pi[:, None] * bk.ctf_re[None] - pr[:, None] * bk.ctf_im[None]
            cc = compare_cuda.fused_displacement_cc(
                conv_re.reshape(o * c, n, f), conv_im.reshape(o * c, n, f), bk.img_re, bk.img_im, wx_re, wx_im, bk.wy_re, bk.wy_im,
                n_fold=eng.n_fold).reshape(o, c, i_n, d, d)
            return displacement_lse(cc, sum_c, bk.sum_ref, f0, ntot, f32_u=eng._f32_corr_ok,
                                    ssq_c=ssq_c, ssq_ref=bk.ssq_ref)
    ms["compare"] = time_ms(compare, dev, reps)
    m, se, ds, ccs = compare()
    se, ds, ccs = (x.reshape(o, c, i_n) for x in (se, ds, ccs))
    m = None if which in ("K1", "K4") else m  # G2 repairs the fused kernels' max
    merge_state = eng.initial_state()

    def merge():
        return posterior_cuda.merge_block(merge_state, m, se, ds, ccs, k, f0, sum_c, ssq_c,
                                          bk.sum_ref, bk.disp, 0, ntot=ntot)

    ms["merge"] = time_ms(merge, dev, reps)
    ms["residual"] = ms["step"] - sum(ms[k] for k in ("projection", "constants", "compare",
                                                      "merge"))
    w = compare_work(o, c, i_n, n, f, d, m_cols, eng.n_fold)
    nbytes = compare_bytes(o, c, i_n, n, f, d, m_cols)
    ops = w["stage1"] + w["rest"]
    b = compare_bound(o, c, i_n, n, f, d, m_cols, eng.n_fold, tensor_cores=True)
    return {
        "phases": ms,
        "compare": {"kernel": which, "operations": ops, "bytes": nbytes,
                    "gflop_per_s": ops / (ms["compare"] * 1e6),
                    "gb_per_s": nbytes / (ms["compare"] * 1e6),
                    "bound_ms": b[0], "bound_by": b[1]},
        "shape": dict(O=o, C=c, I=i_n, N=n, F=f, D=d, n_fold=eng.n_fold),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "timer": "CUDA events" if dev.type == "cuda" else "host clock (CPU)",
    }


def report(out: dict, say=print) -> None:
    s, cmp_ = out["shape"], out["compare"]
    say(f"block: O={s['O']} C={s['C']} I={s['I']} N={s['N']} F={s['F']} D={s['D']} "
        f"n_fold={s['n_fold']} on {out['device']} ({out['timer']})")
    for name, ms in out["phases"].items():
        say(f"{name:<11} {ms:9.4f} ms")
    say(f"compare ({cmp_['kernel']}): {cmp_['operations'] / 1e9:.2f} GFLOP, "
        f"{cmp_['bytes'] / 1e6:.1f} MB -> {cmp_['gflop_per_s']:.1f} GFLOP/s, "
        f"{cmp_['gb_per_s']:.1f} GB/s; bound {cmp_['bound_ms']:.4f} ms ({cmp_['bound_by']})")


def main(argv=None) -> int:
    reps, projection = parse_args(sys.argv[1:] if argv is None else argv, "reps", 10)
    report(profile(engine_for(projection=projection), reps=reps),
           say=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
