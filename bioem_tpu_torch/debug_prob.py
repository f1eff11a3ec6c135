"""Per-evaluation log-posterior dump (reference DEBUG_PROB analogue).

PyTorch counterpart of ``bioem_tpu.debug_prob``. The reference, compiled
with ``-DDEBUG_PROB`` (include/defs.h:52), prints every (iRefMap, iOrient,
iConv, disx, disy, cc, logpro) evaluation from both its CPU and CUDA paths
(bioem_algorithm.h:88-128, bioem_cuda.cu:308-313) so the two can be diffed
line by line at any problem size.

:func:`dump_logpro` recomputes the full per-displacement log posterior of
one image through either branch of the port's block step and returns it
as (logpro, cc) arrays; :func:`write_dump` writes them as the reference's
text lines, so a dump of this package diffs against one of the JAX
package. The two branches:

* ``"plain"`` — the plain branch's einsum lattice (core.posterior) and
  its convolution sums;
* ``"kernel"`` — the cc lattice from ``ops.compare_cuda.
  fused_displacement_cc``: K3 on a CUDA tensor, its plain version on a
  CPU one, one image per launch; the convolution sums as the kernel
  branch computes them (|conv|² = |proj|²·|ctf|²).

Both evaluate logpro = K + a_coef·log1p(u) in the engine's
split-precision decomposition with the engine's true ``log1p`` (the JAX
dump's ``accurate_log1p`` series is a TPU workaround the port does not
carry). The blocks run in a plain loop over ``engine.ang_blocks``.

Env gating (read by the CLI after the outputs are written):

* ``BIOEM_TPU_DEBUG_PROB`` — image index to dump;
* ``BIOEM_TPU_DEBUG_PROB_FILE`` — output path (default ``debug_prob.txt``);
* ``BIOEM_TPU_DEBUG_PROB_KERNEL`` — ``plain`` | ``kernel`` (the JAX names
  ``xla`` | ``pallas`` mean the same); default: the engine's own branch.

Diff two dumps (exit status 0 when they agree within ``--atol`` on the
same keys, 1 otherwise):

    python -m bioem_tpu_torch.debug_prob A.txt B.txt [--atol 1e-3]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Optional

import numpy as np
import torch

from .core.posterior import (
    convolution_sums,
    ctf_prior_term,
    displacement_cc,
    logpro_constants,
)

F32 = torch.float32
F64 = torch.float64

# The JAX package's branch names for the same two paths.
_ALIASES = {"plain": "plain", "kernel": "kernel", "xla": "plain", "pallas": "kernel"}


def _block_logpro(engine, angles, i: int, kernel: str):
    """(logpro, cc) of image ``i`` for one orientation block, each
    (O, C, D, D) f64: engine._block_step's math, every displacement kept."""
    banks = engine.banks
    p = engine.p
    n = p.n_pixels
    ntot = p.n_total_pixels
    pr, pi = engine._project_block(banks, angles)
    o, c = pr.shape[0], engine.n_ctf
    d = banks.wy_re.shape[0]
    img_re, img_im = banks.img_re[i:i + 1], banks.img_im[i:i + 1]
    sref, ssref = banks.sum_ref[i:i + 1], banks.ssq_ref[i:i + 1]
    prior_oc = ctf_prior_term(banks.amp, banks.pha, banks.env, p)[None, :].expand(o, c)

    conv_re = pr[:, None] * banks.ctf_re[None] + pi[:, None] * banks.ctf_im[None]
    conv_im = pi[:, None] * banks.ctf_re[None] - pr[:, None] * banks.ctf_im[None]
    if kernel == "kernel":
        from .ops.compare_cuda import fused_displacement_cc

        # the convolution sums G1 gives the engine's kernel branch
        live = torch.ones(o, dtype=torch.int32, device=pr.device)
        sum_c, ssq_c = engine._kernel_constants(banks, pr, pi, live)[:2]
        cc = fused_displacement_cc(
            conv_re.reshape(o * c, n, p.n_fft_1d), conv_im.reshape(o * c, n, p.n_fft_1d),
            img_re, img_im, *engine.wx_cols, banks.wy_re, banks.wy_im, n_fold=engine.n_fold,
        ).reshape(o, c, 1, d, d)
    else:
        sum_c, ssq_c = convolution_sums(conv_re, conv_im, banks.h, n)
        cc = displacement_cc(conv_re, conv_im, img_re, img_im,
                             banks.wx_re, banks.wx_im, banks.wy_re, banks.wy_im)

    f0, k = logpro_constants(sum_c, ssq_c, sref, ssref, prior_oc, ntot,
                             images_normalized=engine._f32_corr_ok)
    a_coef = (3.0 - ntot) * 0.5
    cc_i = cc[:, :, 0]  # (O, C, D, D) f32
    if engine._f32_corr_ok:
        # The engine's f32 u (core.posterior.displacement_lse). Its f64
        # repair of the ARGMAX term (refine_varying_max) belongs to the
        # merged max, not to single evaluations, so dump-vs-output totals
        # agree to the f32 rounding of v (~1e-7·|v|).
        sc = sum_c[:, :, None, None]
        u = (2.0 * sref[0] * sc * cc_i - float(np.float32(ntot)) * cc_i * cc_i) \
            / f0.to(F32)[:, :, 0, None, None]
        logpro = k[:, :, 0, None, None] + (a_coef * torch.log1p(u)).to(F64)
    else:
        cc64 = cc_i.to(F64)
        sc = sum_c.to(F64)[:, :, None, None]
        ssc = ssq_c.to(F64)[:, :, None, None]
        sr, ssr = sref.to(F64)[0], ssref.to(F64)[0]
        num = 2.0 * sr * sc * cc64 - float(ntot) * cc64 * cc64 - ssr * sc * sc - sr * sr * ssc
        logpro = k[:, :, 0, None, None] + a_coef * torch.log1p(num / f0[:, :, 0, None, None])
    return logpro, cc_i.to(F64)


def dump_logpro(engine, image_index: int, kernel: Optional[str] = None):
    """(logpro, cc) arrays of shape (n_orient, n_ctf, D, D) float64 for one
    image: every posterior evaluation the engine integrates over.

    ``kernel``: ``"plain"`` | ``"kernel"`` (or the JAX names ``"xla"`` |
    ``"pallas"``); None = the engine's own branch (``engine.use_kernels``).
    A mesh engine dumps through the slots holding the image, in
    orientation order (all in this process)."""
    if kernel is None:
        kernel = "kernel" if engine.use_kernels else "plain"
    if kernel not in _ALIASES:
        raise ValueError(f"kernel={kernel!r}: expected one of {sorted(_ALIASES)}")
    if not 0 <= image_index < engine.n_img:
        raise ValueError(f"image index {image_index} outside [0, {engine.n_img})")
    parts = (engine.image_slots(image_index) if hasattr(engine, "image_slots")
             else [(engine, image_index)])
    out_lp, out_cc = [], []
    for eng, row in parts:
        for b in range(eng.ang_blocks.shape[0]):
            lp, cc = _block_logpro(eng, eng.ang_blocks[b], row, _ALIASES[kernel])
            out_lp.append(lp.cpu().numpy())
            out_cc.append(cc.cpu().numpy())
    lp = np.concatenate(out_lp, axis=0)[: engine.n_orient]
    cc = np.concatenate(out_cc, axis=0)[: engine.n_orient]
    return lp, cc


def write_dump(path: str, image_index: int, logpro, cc, disp) -> None:
    """Reference-format dump lines (bioem_algorithm.h:89-92):

    ``Prob: iRefMap I, iOrient O, iConv C, disx X, disy Y, value V, logpro L``
    """
    disp = np.asarray(disp)
    n_o, n_c, d, _ = logpro.shape
    with open(path, "w") as f:
        for o in range(n_o):
            for c in range(n_c):
                for ix in range(d):
                    for iy in range(d):
                        f.write(
                            f"Prob: iRefMap {image_index}, iOrient {o}, "
                            f"iConv {c}, disx {disp[ix]}, disy {disp[iy]}, "
                            f"value {cc[o, c, ix, iy]:.10g}, "
                            f"logpro {logpro[o, c, ix, iy]:.10g}\n"
                        )


_LINE = re.compile(
    r"Prob: iRefMap (-?\d+), iOrient (-?\d+), iConv (-?\d+), "
    r"disx (-?\d+), disy (-?\d+), value (\S+), logpro (\S+)"
)


def read_dump(path: str) -> dict:
    """{(iRefMap, iOrient, iConv, disx, disy): (value, logpro)}"""
    out = {}
    with open(path) as f:
        for line in f:
            m = _LINE.match(line.strip())
            if m:
                key = tuple(int(x) for x in m.groups()[:5])
                out[key] = (float(m.group(6)), float(m.group(7)))
    return out


def diff_dumps(a: dict, b: dict):
    """Compare two parsed dumps. Returns (max_dlogpro, max_dcc, worst_key,
    n_common, n_only_a, n_only_b)."""
    common = a.keys() & b.keys()
    worst = (0.0, None)
    for k in common:
        dl = abs(a[k][1] - b[k][1])
        if dl > worst[0]:
            worst = (dl, k)
    return (
        worst[0],
        max((abs(a[k][0] - b[k][0]) for k in common), default=0.0),
        worst[1],
        len(common),
        len(a.keys() - b.keys()),
        len(b.keys() - a.keys()),
    )


def maybe_dump_from_env(engine) -> Optional[str]:
    """CLI hook: honour BIOEM_TPU_DEBUG_PROB after the main run."""
    idx = os.environ.get("BIOEM_TPU_DEBUG_PROB")
    if idx is None:
        return None
    path = os.environ.get("BIOEM_TPU_DEBUG_PROB_FILE", "debug_prob.txt")
    kernel = os.environ.get("BIOEM_TPU_DEBUG_PROB_KERNEL") or None
    i = int(idx)
    lp, cc = dump_logpro(engine, i, kernel=kernel)
    write_dump(path, i, lp, cc, engine.disp)
    print(f"DEBUG_PROB dump ({lp.size} evaluations) written to: {path}")
    return path


def main(argv=None) -> int:
    """Diff two dumps of either package: 0 when max |Δlogpro| ≤ atol and
    the key sets are equal and not empty, else 1 (the exit status of the
    JAX package's tools/diff_prob_dump.py)."""
    ap = argparse.ArgumentParser(prog="python -m bioem_tpu_torch.debug_prob",
                                 description="Diff two DEBUG_PROB dumps")
    ap.add_argument("dump_a")
    ap.add_argument("dump_b")
    ap.add_argument("--atol", type=float, default=1e-3)
    args = ap.parse_args(argv)

    a = read_dump(args.dump_a)
    b = read_dump(args.dump_b)
    dlog, dcc, worst, n_common, only_a, only_b = diff_dumps(a, b)
    print(f"common evaluations: {n_common}")
    if only_a or only_b:
        print(f"keys only in {args.dump_a}: {only_a}")
        print(f"keys only in {args.dump_b}: {only_b}")
    print(f"max |dlogpro| = {dlog:.6g}")
    print(f"max |dcc|     = {dcc:.6g}")
    if worst is not None:
        print("worst at iRefMap %d iOrient %d iConv %d disx %d disy %d" % worst)
    ok = dlog <= args.atol and not only_a and not only_b and n_common > 0
    print("MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
