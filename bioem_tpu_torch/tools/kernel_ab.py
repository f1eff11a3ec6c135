"""A/B of the kernels K1–K4 against another checkout's, on one card.

    python -m bioem_tpu_torch.tools.kernel_ab OTHER_ROOT [--reps 20] [--kernels K1,K2,K3,K4]

Builds the kernel library of ``OTHER_ROOT/bioem_tpu_torch`` with that
checkout's own ``ops/_build.py`` and times its K1 (``bioem_fused_compare``),
K2 (``bioem_fourier_project``), K3 (``bioem_fused_displacement_cc``) and K4
(``bioem_fused_compare_batched``, tiles 8 and 16) against this checkout's,
in one process on the production block's inputs
(``kernel_probe.production_block_inputs`` and
``production_projection_inputs``), in turns other, this, this, other.
Prints each time (the card's own time, ``kernel_probe.device_ms``: the
launches queued behind a spin of the card, so that the host's time to
launch them does not enter, which matters for K2's tens of microseconds;
mean over ``--reps`` launches after a warm-up) and the largest difference
between the two libraries' outputs:
|Δm| and the share of equal argmaxes for K1 and K4, max |Δ| for K2 and K3
(K3 bit-equal when it is 0). K1, K2 and K3 have changed their C
signatures (K1 and K3 now take K1's tiling and a scratch buffer, K2
per-group point counts); the other side is called with the signature its
``_build.SIGNATURES`` declares (a K1 or K3 of the new signature with this
checkout's tiling), so any checkout that has K4 can be the other side.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

from ..ops import _build, compare_cuda
from .kernel_probe import (
    _require_card,
    device_ms,
    production_block_inputs,
    production_projection_inputs,
)


def other_library(root: str):
    """The ``ops/_build.py`` module of the checkout at ``root``: its
    ``load()`` builds that checkout's kernel library (into its own
    ``bioem_tpu_torch/_build``), its ``SIGNATURES`` name the entries."""
    path = os.path.join(os.path.abspath(root), "bioem_tpu_torch", "ops", "_build.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bioem_tpu_torch/ops/_build.py under {root}")
    spec = importlib.util.spec_from_file_location("other_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="K1,K2,K3,K4",
                    help="comma-separated subset of K1,K2,K3,K4 (default: all)")
    args = ap.parse_args(argv)
    chosen = set(args.kernels.split(","))
    dev = _require_card()
    mod = other_library(args.other)
    libs = {"other": mod.load(), "this": _build.load()}
    # The earlier K1 entry: twelve inputs, a_coef, eight ints, four outputs, the stream.
    other_k1_old = len(mod.SIGNATURES["bioem_fused_compare"]) == 26
    other_k2_old = len(mod.SIGNATURES["bioem_fourier_project"]) == 13
    # The earlier K3 entry: eight inputs, seven ints, the output, the stream.
    other_k3_old = len(mod.SIGNATURES["bioem_fused_displacement_cc"]) == 17
    inputs, a_coef, n_fold = production_block_inputs(dev)
    (o, n, f), c, i, (d, m) = inputs[0].shape, inputs[2].shape[0], inputs[4].shape[0], inputs[6].shape
    proj = production_projection_inputs(dev)
    conv_re = (inputs[0][:, None] * inputs[2][None] + inputs[1][:, None] * inputs[3][None]).reshape(o * c, n, f)
    conv_im = (inputs[1][:, None] * inputs[2][None] - inputs[0][:, None] * inputs[3][None]).reshape(o * c, n, f)
    k3_in = (conv_re, conv_im, *inputs[4:10])
    print(f"card: {torch.cuda.get_device_name(dev)}; production block O={o} C={c} I={i} "
          f"N={n} F={f} D={d} n_fold={n_fold}; K2 G={proj[0].shape[0]} Pp={proj[0].shape[2]} "
          f"with {int(proj[5].sum())} points", flush=True)
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
            status = lib.bioem_fourier_project(*head, st_re.data_ptr(), st_im.data_ptr(), g_n,
                                               o_n, pp, n, f, *(t.data_ptr() for t in out),
                                               stream())
            _build.check(status, f"{side} K2")
            return out
        if kernel == "K3":
            cc = torch.empty((o * c, i, d, d), device=dev)
            head = (*(t.data_ptr() for t in k3_in), o * c, i, n, f, d, m, n_fold)
            if side == "other" and other_k3_old:
                status = lib.bioem_fused_displacement_cc(*head, cc.data_ptr(), stream())
            else:
                n_wg, kc, _ = compare_cuda.k1_plan(d, m, f, n_fold)
                scratch = compare_cuda._scratch(lib, o * c, n, d, m, f, n_fold, n_wg, kc, dev)
                status = lib.bioem_fused_displacement_cc(*head, n_wg, kc, cc.data_ptr(),
                                                         scratch.data_ptr(), stream())
            _build.check(status, f"{side} K3")
            return (cc,)
        if kernel == "K1" and side == "this":
            return compare_cuda.launch_k1("this K1", inputs, a_coef, n_fold)
        outs = compare_cuda._summary_outputs(o * c, i, dev)
        if kernel == "K1" and not other_k1_old:
            # the other side has this checkout's K1 entry: this checkout's tiling
            n_wg, kc, _ = compare_cuda.k1_plan(d, m, f, n_fold)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
