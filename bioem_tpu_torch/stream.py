"""Image-streaming engine mode: particle sets larger than the card's memory.

PyTorch counterpart of ``bioem_tpu.stream``. The reference never holds the
full working set on the GPU — images are tiled through in chunks of
``nTotParallelMaps`` = 1024 (reference map.cpp:549, include/defs.h:182).
Here an outer **host loop over image chunks** runs one engine: it is built
once on the first chunk (CTF bank, orientation blocks, and on the card's
kernel branch the captured block step), and each later chunk swaps only
the image banks in (:meth:`BioEMEngine.swap_images`: the same shapes, so
the one captured graph replays every chunk; its banks are copied into the
graph's in place).

Chunking trades re-projection for memory: every chunk re-runs the full
orientation scan, so projection and CTF work repeat ``n_chunks`` times.
The posterior state is per image, so merging chunks is plain
concatenation and a streamed run equals a whole run image for image.

Overlap, as the reference's async pipeline overlaps H2D with compute
(bioem_cuda.cu:527-566): a prefetch thread reads chunk k+1, precomputes
its FFT bank (``_image_arrays``) and pins it while chunk k runs; on the
card its H2D copy then runs on a side stream under chunk k's replays
(``BioEMEngine._place_banks``). ``results()`` is the only synchronisation
per chunk (on a mesh, ``run()`` ends in the merge, which synchronises).

On a mesh (``cfg.mesh_images × cfg.mesh_orient > 1``) each chunk runs on
every slot, each slot's banks swapped in; in a multi-process run each
process reads from the source only the rows its slots own
(:func:`_read_chunk_local`), as the JAX package's per-host ingest does.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Protocol

import numpy as np

from .config import RunConfig
from .core.engine import BioEMEngine, Results
from .io.map_io import ImageStack, _normalize_stack
from .io.mrc import read_mrc_header


class ImageSource(Protocol):
    """Chunked access to a (possibly huge) particle set."""

    @property
    def n_images(self) -> int: ...

    def chunk(self, start: int, stop: int) -> np.ndarray:
        """(stop-start, N, N) float32, already normalised."""
        ...


@dataclass
class ArraySource:
    """In-RAM stack (an ImageStack's maps or an ndarray) as an ImageSource."""

    maps: np.ndarray

    @property
    def n_images(self) -> int:
        return self.maps.shape[0]

    def chunk(self, start: int, stop: int) -> np.ndarray:
        return self.maps[start:stop]


@dataclass
class MRCStackSource:
    """Lazy single-file MRC stack: only the requested chunk is read and
    normalised (reference map.cpp:663-853 semantics — transpose + per-image
    zero-mean/unit-σ unless NO_MAP_NORM). Each read opens its own handle,
    so the prefetch thread may read while the main thread runs."""

    path: str
    n_pixels: int
    normalize: bool = True

    def __post_init__(self):
        hdr = read_mrc_header(self.path)
        if hdr.nr != self.n_pixels or hdr.nc != self.n_pixels:
            raise ValueError(
                f"Inconsistent number of pixels in maps and inputfile "
                f"({self.n_pixels}, i {hdr.nc}, j {hdr.nr})"
            )
        if hdr.mode != 2:
            raise ValueError(f"MRC mode {hdr.mode} not supported (mode-2 only)")
        self._hdr = hdr

    @property
    def n_images(self) -> int:
        return self._hdr.ns

    def chunk(self, start: int, stop: int) -> np.ndarray:
        hdr = self._hdr
        n = self.n_pixels
        per = n * n
        with open(self.path, "rb") as f:
            f.seek(1024 + hdr.nsymbt + start * per * 4)
            dt = np.dtype(hdr.byteorder + "f4")
            data = np.fromfile(f, dtype=dt, count=(stop - start) * per)
        if data.size != (stop - start) * per:
            raise IOError(f"Converting Data: {self.path}")
        data = data.astype(np.float32).reshape(stop - start, n, n)
        stack = np.ascontiguousarray(np.transpose(data, (0, 2, 1)))
        return _normalize_stack(stack) if self.normalize else stack


def _concat_results(parts: list) -> Results:
    first = parts[0]

    def cat(field):
        return np.concatenate([getattr(r, field) for r in parts])

    angle_log = None
    angle_raw = None
    if first.angle_log is not None:
        angle_log = np.concatenate([r.angle_log for r in parts], axis=0)
        angle_raw = tuple(
            np.concatenate([r.angle_raw[k] for r in parts], axis=0) for k in range(2)
        )
    return Results(
        log_prob=cat("log_prob"),
        constoadd=cat("constoadd"),
        total=cat("total"),
        best_orient=cat("best_orient"),
        best_conv=cat("best_conv"),
        best_cent_x=cat("best_cent_x"),
        best_cent_y=cat("best_cent_y"),
        best_norm=cat("best_norm"),
        best_mu=cat("best_mu"),
        angle_log=angle_log,
        log_norm_const=first.log_norm_const,
        angle_raw=angle_raw,
        grid=first.grid,
    )


def _read_chunk_local(source: ImageSource, start: int, stop: int, eng) -> np.ndarray:
    """Chunk [start, stop), reading from the source only the rows this
    process's slots own (multi-process per-process ingest). Unowned rows
    hold a finite placeholder (a copy of the first row read): no local
    slot computes on them, they only keep the host FFT and sums finite."""
    from .parallel.distributed import process_count

    n = stop - start
    if process_count() == 1 or not hasattr(eng, "owned_image_rows"):
        return source.chunk(start, stop)
    ranges = [(max(a, 0), min(b, n)) for a, b in eng.owned_image_rows()]
    ranges = [(a, b) for a, b in ranges if a < b]
    if not ranges:  # this process owns only padding rows of a short chunk
        ranges = [(0, 1)]
    first = source.chunk(start + ranges[0][0], start + ranges[0][1])
    maps = np.broadcast_to(first[:1], (n,) + first.shape[1:]).copy()
    maps[ranges[0][0]:ranges[0][1]] = first
    for a, b in ranges[1:]:
        maps[a:b] = source.chunk(start + a, start + b)
    return maps


def run_streaming(
    p,
    orients,
    model,
    source: ImageSource,
    cfg: Optional[RunConfig] = None,
    chunk_images: int = 1024,
    progress: bool = False,
    device=None,
    mesh=None,
) -> tuple:
    """Full posterior over an image set streamed in chunks.

    Returns (results, perf) with results equal, image for image, to a
    non-streamed run over the whole set on the same branch. ``device``
    None is the card, or the CPU with ``BIOEM_TPU_FORCE_CPU``
    (config.resolve_device); ``mesh`` places a mesh run's slots
    (run.make_engine). ``perf`` holds the pass seconds, comparisons,
    chunks and the engine's captures of its block step (one on the card's
    kernel branch, whatever the number of chunks; 0 elsewhere).

    Checkpointing composes: each chunk checkpoints to its own file
    (``cfg.checkpoint_path + '.chunk<k>'``) under a fingerprint tied to the
    chunk's image range, so a restarted run resumes chunk-accurate — a
    completed earlier chunk is loaded, never recomputed, and never
    mistaken for a later chunk's result. On a mesh the engine is a
    :class:`~bioem_tpu_torch.parallel.mesh.ShardedBioEMEngine` and each
    slot's file gets ``.slot<i>x<o>`` appended.
    """
    from .run import make_engine

    cfg = cfg or RunConfig()
    n_total = source.n_images
    chunk_images = min(chunk_images, n_total)
    eng: Optional[BioEMEngine] = None
    parts: list = []
    perf = {"run_s": 0.0, "comparisons": 0, "chunks": 0, "captures": 0}
    spans = [(s, min(s + chunk_images, n_total)) for s in range(0, n_total, chunk_images)]

    def _prepare(start: int, stop: int) -> dict:
        # host read + normalisation + FFT precompute + pinning of a chunk;
        # _image_arrays reads only engine constants (thread-safe)
        return eng.pin_fields(eng._image_arrays(_read_chunk_local(source, start, stop, eng)))

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        banks_next = None
        for ci, (start, stop) in enumerate(spans):
            if eng is None:
                # The first chunk is read whole on every process: the engine
                # hashes its images into the checkpoint fingerprint, which
                # must not depend on the process.
                eng = make_engine(p, orients, model, ImageStack(source.chunk(start, stop)), cfg,
                                  device=device, mesh=mesh)
                banks = eng.banks
            else:
                banks = banks_next if banks_next is not None else eng._place_banks(
                    _prepare(start, stop))
            ckpt = f"{cfg.checkpoint_path}.chunk{ci}" if cfg.checkpoint_path else None
            t0 = time.perf_counter()
            state = eng.run(banks=banks, bank_tag=f"images[{start}:{stop}]",
                            checkpoint_path=ckpt)
            # run() queues the chunk's blocks on the card and returns; the
            # next chunk's banks are placed meanwhile (on the card, copies
            # on a side stream under this chunk's replays). results() below
            # is the chunk's one synchronisation. The first prefetch starts
            # only now: the first run() captures the block step, and the
            # prefetch thread's pinned allocation (cudaHostAlloc) during a
            # capture invalidates it (on a mesh run() has run every local
            # slot, so every slot's capture precedes it).
            if ci + 1 < len(spans):
                if pending is None:
                    pending = pool.submit(_prepare, *spans[ci + 1])
                banks_next = eng._place_banks(pending.result())
                pending = pool.submit(_prepare, *spans[ci + 2]) if ci + 2 < len(spans) else None
            parts.append(eng.results(state, n_img=stop - start))
            dt = time.perf_counter() - t0
            perf["run_s"] += dt
            perf["comparisons"] += (stop - start) * eng.n_orient * eng.n_ctf
            perf["chunks"] += 1
            if progress:
                print(f"chunk {perf['chunks']}: images [{start}, {stop}) in {dt:.2f}s "
                      f"({(stop - start) * eng.n_orient * eng.n_ctf / dt:.3e} cmp/s)")
    perf["captures"] = eng.captures
    results = _concat_results(parts)
    results.grid = eng.grid
    return results, perf
