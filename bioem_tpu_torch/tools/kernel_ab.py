"""A/B of the comparison kernels against another checkout's, on one card.

    python -m bioem_tpu_torch.tools.kernel_ab OTHER_ROOT [--reps 20]

Builds the kernel library of ``OTHER_ROOT/bioem_tpu_torch`` with that
checkout's own ``ops/_build.py`` and times its K1 (``bioem_fused_compare``)
and K4 (``bioem_fused_compare_batched``, tiles 8 and 16) against this
checkout's, in one process on the production block's inputs
(``kernel_probe.production_block_inputs``), in turns other, this, this,
other. Prints each time (CUDA events, mean over ``--reps`` launches after a
warm-up) and the largest |Δm| between the two libraries' outputs. The two
C entry points have kept their signatures since they were added, so any
checkout that has K4 can be the other side.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

from ..ops import _build, compare_cuda
from .kernel_probe import _require_card, production_block_inputs, time_ms


def other_library(root: str):
    """The kernel library of the checkout at ``root``, built by its own
    ``_build.py`` (into that checkout's ``bioem_tpu_torch/_build``)."""
    path = os.path.join(os.path.abspath(root), "bioem_tpu_torch", "ops", "_build.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bioem_tpu_torch/ops/_build.py under {root}")
    spec = importlib.util.spec_from_file_location("other_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = _require_card()
    libs = {"other": other_library(args.other), "this": _build.load()}
    inputs, a_coef, n_fold = production_block_inputs(dev)
    (o, n, f), c, i, (d, m) = inputs[0].shape, inputs[2].shape[0], inputs[4].shape[0], inputs[6].shape
    print(f"card: {torch.cuda.get_device_name(dev)}; production block O={o} C={c} I={i} "
          f"N={n} F={f} D={d} n_fold={n_fold}", flush=True)

    def call(side: str, kernel: str, tile: int):
        outs = compare_cuda._summary_outputs(o * c, i, dev)
        ptrs = [t.data_ptr() for t in inputs]
        head = (*ptrs, float(a_coef), o, c, i, n, f, d, m, n_fold)
        tail = (*(t.data_ptr() for t in outs), torch.cuda.current_stream(dev).cuda_stream)
        lib = libs[side]
        if kernel == "K1":
            status = lib.bioem_fused_compare(*head, *tail)
        else:
            status = lib.bioem_fused_compare_batched(*head, tile, *tail)
        _build.check(status, f"{side} {kernel}")
        return outs

    for kernel, tile in (("K1", 0), ("K4", 8), ("K4", 16)):
        a, b = call("other", kernel, tile), call("this", kernel, tile)
        torch.cuda.synchronize()
        dm = float((a[0] - b[0]).abs().max())
        same_ds = float((a[2] == b[2]).float().mean())
        times = [time_ms(lambda s=s: call(s, kernel, tile), args.reps)
                 for s in ("other", "this", "this", "other")]
        name = kernel + (f" tile {tile}" if tile else "")
        print(f"{name}: other {times[0]:.4f} ms, this {times[1]:.4f} ms, this {times[2]:.4f} ms, "
              f"other {times[3]:.4f} ms; max |Δm| {dm:.3e}, argmax equal on {same_ds:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
