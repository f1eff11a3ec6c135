"""A/B of the kernels K1–K4 and the probe P1 against another checkout's, on one card.

    python -m bioem_tpu_torch.tools.kernel_ab OTHER_ROOT [--reps 20] [--kernels K1,K2,K3,K4,P1]
        [--block production|reference|wide]

Builds the kernel library of ``OTHER_ROOT/bioem_tpu_torch`` with that
checkout's own ``ops/_build.py`` and times its K1 (``bioem_fused_compare``),
K2 (``bioem_fourier_project``), K3 (``bioem_fused_displacement_cc``) and K4
(``bioem_fused_compare_batched``, tiles 8 and 16) against this checkout's,
in one process on the production block's inputs
(``kernel_probe.production_block_inputs`` and
``production_projection_inputs``; ``--block reference``: K1 and K3 on a
block of the reference's production grid, O=8, C=32, I=64, N=224, D=81 at
stride 1; ``--block wide``: O=8, C=8, I=64, N=224, D=121;
``kernel_probe.BLOCKS``), in turns other, this, this, other.
Prints each time (the card's own time, ``kernel_probe.device_ms``: the
launches queued behind a spin of the card, so that the host's time to
launch them does not enter, which matters for K2's tens of microseconds;
mean over ``--reps`` launches after a warm-up) and the largest difference
between the two libraries' outputs:
|Δm| and the share of equal argmaxes for K1 and K4, max |Δ| for K2 and K3
(K3 bit-equal when it is 0). K1, K2 and K3 have changed their C
signatures (K1 and K3 now take K1's tiling and a scratch buffer, K2
per-group point counts and an optional scale, passed as none); the other side is called with the signature its
``_build.SIGNATURES`` declares (a K1 or K3 of the new signature with the
tiling its own ``compare_cuda.k1_plan`` picks from its own library's
shared-memory formula, :func:`lib_plan`), so any checkout that has K4 can
be the other side.
P1 (``bioem_probe_f32_product``, whose C signature has not changed) is
timed scheme by scheme at K4's stage-1 shape (``kernel_probe.K4_STAGE1``:
512 products of (48×224)·(224×1024)), with the largest difference between
the two libraries' outputs; it runs only when named in ``--kernels``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import types

import torch

from ..ops import _build, compare_cuda, probe_cuda
from .kernel_probe import (
    BLOCKS,
    K4_STAGE1,
    _require_card,
    block_inputs,
    device_ms,
    production_projection_inputs,
)


def other_library(root: str):
    """The ``ops/_build.py`` module of the checkout at ``root``: its
    ``load()`` builds that checkout's kernel library (into its own
    ``bioem_tpu_torch/_build``), its ``SIGNATURES`` name the entries. It is
    imported inside that checkout's package, under another name, so that
    its relative imports resolve there."""
    pkg_dir = os.path.join(os.path.abspath(root), "bioem_tpu_torch")
    if not os.path.exists(os.path.join(pkg_dir, "ops", "_build.py")):
        raise FileNotFoundError(f"no bioem_tpu_torch/ops/_build.py under {root}")
    name = "_other_bioem_tpu_torch"
    pkg = types.ModuleType(name)
    pkg.__path__ = [pkg_dir]
    sys.modules[name] = pkg
    return importlib.import_module(f"{name}.ops._build")


def lib_plan(cc_mod, lib, d: int, m: int, f: int, n_fold: int) -> tuple:
    """K1's tiling (warpgroups, K-chunk steps) by a checkout's own
    ``compare_cuda.k1_plan`` (``cc_mod``: its order of tilings) from its
    kernel library's shared-memory formula: each checkout's K1 and K3 run
    with the plan its own kernel was built for."""
    plan = cc_mod.k1_plan(d, m, f, n_fold, lib.bioem_fused_compare_smem_bytes)
    if plan is None:
        raise ValueError(f"no K1 tiling at D={d}, M={m}, F={f}, n_fold={n_fold}")
    return plan[:2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="K1,K2,K3,K4",
                    help="comma-separated subset of K1,K2,K3,K4,P1 (default: K1–K4)")
    ap.add_argument("--block", choices=sorted(BLOCKS), default="production",
                    help="the comparison block K1, K3 and K4 run on (K4 has no instance "
                         "for the reference grid's D = 81)")
    args = ap.parse_args(argv)
    chosen = set(args.kernels.split(","))
    dev = _require_card()
    mod = other_library(args.other)
    libs = {"other": mod.load(), "this": _build.load()}
    plan_mods = {"other": importlib.import_module(f"{mod.__package__}.compare_cuda"),
                 "this": compare_cuda}
    # The earlier K1 entry: twelve inputs, a_coef, eight ints, four outputs, the stream.
    other_k1_old = len(mod.SIGNATURES["bioem_fused_compare"]) == 26
    other_k2_old = len(mod.SIGNATURES["bioem_fourier_project"]) == 13
    # The earlier K2 entry without the scale pointer (K2 then stored unscaled spectra).
    other_k2_unscaled = len(mod.SIGNATURES["bioem_fourier_project"]) <= 14
    # The earlier K3 entry: eight inputs, seven ints, the output, the stream.
    other_k3_old = len(mod.SIGNATURES["bioem_fused_displacement_cc"]) == 17
    inputs, a_coef, n_fold = block_inputs(dev, *BLOCKS[args.block])
    (o, n, f), c, i, (d, m) = inputs[0].shape, inputs[2].shape[0], inputs[4].shape[0], inputs[6].shape
    plans = {side: lib_plan(plan_mods[side], lib, d, m, f, n_fold) for side, lib in libs.items()
             if not (side == "other" and other_k1_old)}
    if d > 32:
        chosen.discard("K4")
    proj = production_projection_inputs(dev)
    conv_re = (inputs[0][:, None] * inputs[2][None] + inputs[1][:, None] * inputs[3][None]).reshape(o * c, n, f)
    conv_im = (inputs[1][:, None] * inputs[2][None] - inputs[0][:, None] * inputs[3][None]).reshape(o * c, n, f)
    k3_in = (conv_re, conv_im, *inputs[4:10])
    print(f"card: {torch.cuda.get_device_name(dev)}; {args.block} block O={o} C={c} I={i} "
          f"N={n} F={f} D={d} n_fold={n_fold}; K1/K3 plans {plans}; K2 G={proj[0].shape[0]} "
          f"Pp={proj[0].shape[2]} with {int(proj[5].sum())} points", flush=True)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def call(side: str, kernel: str, tile: int):
        lib = libs[side]
        if kernel == "K2":
            i0, j0, dens, st_re, st_im, counts = proj
            g_n, o_n, pp = i0.shape
            out = (torch.empty((o_n, n, f), device=dev), torch.empty((o_n, n, f), device=dev))
            head = [i0.data_ptr(), j0.data_ptr(), dens.data_ptr()]
            if not (side == "other" and other_k2_old):
                head.append(counts.data_ptr())
            head += [st_re.data_ptr(), st_im.data_ptr()]
            if not (side == "other" and other_k2_unscaled):
                head.append(None)  # no scale: both sides store the unscaled spectra
            status = lib.bioem_fourier_project(*head, g_n, o_n, pp, n, f,
                                               *(t.data_ptr() for t in out), stream())
            _build.check(status, f"{side} K2")
            return out
        if kernel == "K3":
            cc = torch.empty((o * c, i, d, d), device=dev)
            head = (*(t.data_ptr() for t in k3_in), o * c, i, n, f, d, m, n_fold)
            if side == "other" and other_k3_old:
                status = lib.bioem_fused_displacement_cc(*head, cc.data_ptr(), stream())
            else:
                n_wg, kc = plans[side]
                scratch = compare_cuda._scratch(lib, o * c, n, d, m, f, n_fold, n_wg, kc, dev)
                status = lib.bioem_fused_displacement_cc(*head, n_wg, kc, cc.data_ptr(),
                                                         scratch.data_ptr(), stream())
            _build.check(status, f"{side} K3")
            return (cc,)
        if kernel == "K1" and side == "this":
            return compare_cuda.launch_k1("this K1", inputs, a_coef, n_fold)
        outs = compare_cuda._summary_outputs(o * c, i, dev)
        if kernel == "K1" and not other_k1_old:
            # the other side has this checkout's K1 entry, with its own tiling
            n_wg, kc = plans[side]
            scratch = compare_cuda._scratch(lib, o * c, n, d, m, f, n_fold, n_wg, kc, dev)
            status = lib.bioem_fused_compare(
                *(t.data_ptr() for t in inputs), float(a_coef), o, c, i, n, f, d, m, n_fold,
                n_wg, kc, *(t.data_ptr() for t in outs), scratch.data_ptr(), stream())
            _build.check(status, f"{side} K1")
            return outs
        head = (*(t.data_ptr() for t in inputs), float(a_coef), o, c, i, n, f, d, m, n_fold)
        tail = (*(t.data_ptr() for t in outs), stream())
        if kernel == "K1":
            status = lib.bioem_fused_compare(*head, *tail)
        else:
            status = lib.bioem_fused_compare_batched(*head, tile, *tail)
        _build.check(status, f"{side} {kernel}")
        return outs

    for kernel, tile in (("K1", 0), ("K2", 0), ("K3", 0), ("K4", 8), ("K4", 16)):
        if kernel not in chosen:
            continue
        a, b = call("other", kernel, tile), call("this", kernel, tile)
        torch.cuda.synchronize()
        if kernel in ("K1", "K4"):
            diff = (f"max |Δm| {float((a[0] - b[0]).abs().max()):.3e}, argmax equal on "
                    f"{float((a[2] == b[2]).float().mean()):.4f}")
        else:
            diff = f"max |Δ| {max(float((x - y).abs().max()) for x, y in zip(a, b)):.3e}"
        times = [device_ms(lambda s=s: call(s, kernel, tile), args.reps)
                 for s in ("other", "this", "this", "other")]
        name = kernel + (f" tile {tile}" if tile else "")
        print(f"{name}: other {times[0]:.4f} ms, this {times[1]:.4f} ms, this {times[2]:.4f} ms, "
              f"other {times[3]:.4f} ms; {diff}", flush=True)
    if "P1" in chosen:
        ab_p1(libs, dev, args.reps)
    return 0


def ab_p1(libs: dict, dev, reps: int) -> None:
    """P1 of both libraries, scheme by scheme, at K4's stage-1 shape."""
    m, k, n, batch = K4_STAGE1
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((m, k), generator=gen).to(dev)
    b = torch.randn((k, n), generator=gen).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(side: str, code: int):
        out = torch.empty((batch, m, n), device=dev)
        status = libs[side].bioem_probe_f32_product(code, a.data_ptr(), b.data_ptr(),
                                                    out.data_ptr(), m, k, n, batch, stream)
        _build.check(status, f"{side} P1")
        return out

    for code, scheme in enumerate(probe_cuda.SCHEMES):
        x, y = call("other", code), call("this", code)
        torch.cuda.synchronize()
        diff = float((x - y).abs().max()) / float(x.abs().max())
        del x, y
        times = [device_ms(lambda s=s: call(s, code), reps)
                 for s in ("other", "this", "this", "other")]
        print(f"P1 {scheme} ({m}x{k})·({k}x{n}) × {batch}: other {times[0]:.4f} ms, "
              f"this {times[1]:.4f} ms, this {times[2]:.4f} ms, other {times[3]:.4f} ms; "
              f"max |Δ| {diff:.3e} of max|C|", flush=True)


if __name__ == "__main__":
    sys.exit(main())
