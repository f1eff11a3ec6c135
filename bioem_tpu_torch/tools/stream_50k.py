"""BASELINE config-5 image scale on one card: 50,000 images of 224², streamed.

The port's counterpart of the JAX package's ``tools/stream_50k.py``. The
conj-FFT image bank of 50k 224² particles is ~10 GB before any
intermediate; ``run_streaming`` (stream.py) holds one chunk's banks on the
card at a time (the reference chunks its GPU images the same way, 1024 at
a time) and replays one captured block step for every chunk.

The images are made per chunk (``SyntheticSource``: chunk [start, stop) is
seeded by ``start``, as in the JAX tool), so the host never holds the
whole stack either. Each chunk is normalised per image as the MRC ingest
does (``MRCStackSource`` does the same), so the engine's f32 gate opens
and the production comparison (K1) runs; the JAX tool's raw noise fails
that gate (over 1024 images the largest sum²/Σ² of unit noise far exceeds
its 5e-5·N² limit) and takes the hybrid. The orientations are the
production problem's model and CTFs (``tools/problem.py``) on a
``BENCH_NORIENT`` (default 4608) super-Fibonacci list: at few
orientations the per-chunk fixed cost dominates the streamed rate.

    python -m bioem_tpu_torch.tools.stream_50k [n_images] [chunk] [--mesh IxO]

(defaults 50000 1024, no mesh). ``--mesh 2x2`` streams every chunk through
an (images × orientations) mesh whose slots take this process's cards in
turn (several slots may share one card). Prints one JSON line. The card,
or the CPU with ``BIOEM_TPU_FORCE_CPU=1``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


class SyntheticSource:
    """Lazy image source: chunk [start, stop) is made on demand from seed
    ``start`` and normalised per image."""

    def __init__(self, n_images: int, n_pixels: int):
        self._n = n_images
        self._npix = n_pixels

    @property
    def n_images(self) -> int:
        return self._n

    def chunk(self, start: int, stop: int) -> np.ndarray:
        from ..io.map_io import _normalize_stack

        rng = np.random.default_rng(start)
        return _normalize_stack(
            rng.normal(0, 1, (stop - start, self._npix, self._npix)).astype(np.float32))


def stream(n_images: int = 50_000, chunk: int = 1024, mesh_shape=None, n_orient=None,
           device=None, progress: bool = False, **problem_kw) -> tuple:
    """(record, results) of one streamed pass; ``problem_kw`` goes to
    ``problem.build_problem`` (its images are not used)."""
    import torch

    from ..config import RunConfig, resolve_device
    from ..stream import run_streaming
    from .mesh_scale_bench import slot_devices
    from .problem import build_problem
    from .scale_bench import peak_card_mb, reset_peak

    dev = resolve_device(device)
    n_orient = n_orient or int(os.environ.get("BENCH_NORIENT", 4608))
    p, orients, model, _, _ = build_problem(n_orient=n_orient, **{"n_img": 1, **problem_kw})
    cfg = RunConfig.from_env()
    cfg.autotune = False
    mesh = None
    if mesh_shape is not None:
        from ..parallel.distributed import initialize, process_count
        from ..parallel.mesh import make_bioem_mesh

        initialize()  # a multi-process run, when one is configured
        cfg.mesh_images, cfg.mesh_orient = mesh_shape
        need = -(-mesh_shape[0] * mesh_shape[1] // process_count())
        mesh = make_bioem_mesh(*mesh_shape, devices=slot_devices(need, dev))
    held_mb = reset_peak(dev)
    t0 = time.perf_counter()
    results, perf = run_streaming(p, orients, model, SyntheticSource(n_images, p.n_pixels), cfg,
                                  chunk_images=chunk, progress=progress, device=dev, mesh=mesh)
    wall = time.perf_counter() - t0
    if results.log_prob.shape != (n_images,) or not np.isfinite(results.log_prob).all():
        raise RuntimeError("the streamed logP is not finite for every image")
    rec = {
        "n_images": n_images,
        "mesh": list(mesh_shape) if mesh_shape else [1, 1],
        "n_orient": n_orient,
        "n_ctf": p.n_ctf,
        "chunk_images": chunk,
        "chunks": perf["chunks"],
        "comparisons": perf["comparisons"],
        "device_s": perf["run_s"],
        "wall_s": wall,
        "comparisons_per_s_device_loop": perf["comparisons"] / perf["run_s"],
        "captures": perf["captures"],
        "peak_card_mb": peak_card_mb(dev),
        "card_mb_at_start": held_mb,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return rec, results


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mesh_shape = None
    if "--mesh" in args:
        i = args.index("--mesh")
        mesh_shape = tuple(int(v) for v in args[i + 1].split("x"))
        del args[i:i + 2]
    n_images = int(args[0]) if len(args) > 0 else 50_000
    chunk = int(args[1]) if len(args) > 1 else 1024
    rec, _ = stream(n_images, chunk, mesh_shape, progress=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
