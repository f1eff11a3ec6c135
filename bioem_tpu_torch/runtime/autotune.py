"""Block-size / kernel-choice autotuner.

PyTorch counterpart of ``bioem_tpu.runtime.autotune`` (the reference's
autotuner, autotuner.cpp:16-149, tunes its GPU/CPU workload split by
bisection on comparison timings). On one card there is no host/device
split; the tunables are the orientation block, the comparison path (K1,
the image-batched K4 at an image tile, or the hybrid K3 + torch
displacement LSE) and K4's tile. The search is a timed argmin over a
small candidate set, measured on the real problem's first orientation
blocks (:data:`SPAN_COMPARISONS` comparisons) after a dropped warm-up pass.
Like the JAX tuner, which times its jitted scan, each candidate is timed
on the loop its pass runs: on the card's kernel branch, replays of the
engine's captured block step (``BioEMEngine.time_blocks``; each
candidate engine captures its own graph, released with the engine and
``torch.cuda.empty_cache()``), so the host's dispatch of each kernel no
longer enters the choice.

Winners are cached per (device kind, problem shape) in the same file as
the JAX package's (``.bioem_tpu_autotune.json`` in the working directory,
or ``BIOEM_TPU_AUTOTUNE_CACHE``; ``/dev/null`` disables it), with the same
nearest-power-of-two shape buckets, forced-knob and debug-cap key rules,
and atomic store. A forced knob is never overridden by a cached entry, an
untimed winner is never stored, and a corrupt cache never stops a run.

Differences from the JAX module:

* every key starts with ``torch|``: the two packages never read each
  other's entries from a shared cache file (their field names differ,
  and both would write ``cpu|…`` keys on a CPU);
* the device kind is ``torch.cuda.get_device_name()`` (``cpu`` off the card);
* each candidate is timed over a fixed number of comparisons, not over
  1024 orientations, so a large image set does not multiply the tuner's
  cost (the two agree on the production problem);
* Mosaic's lane rule for fused tiles is TPU-only and gone, and so is the
  search over K4's image tile: the CUDA K4's work does not depend on it.
  K4 is a candidate where the kernel takes the problem (its lattice
  width and shared memory, :func:`k4_runs`);
* the TPU health gate (``runtime/health.py``) is not ported, so every
  timed winner is stored;
* a candidate that the engine refuses (ValueError) or that runs out of
  device memory loses; any other error, a failed kernel build or launch
  among them, raises (no fallback on the card).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import RunConfig, resolve_device

# Tuned fields persisted across processes.
_CACHED_FIELDS = ("orient_block", "image_block", "use_kernels",
                  "kernel_img_tile", "fused_lse", "fused_batched")

# Comparisons each candidate's timed span covers: 1024 orientations of the
# production problem (8 CTFs × 64 images). A span fixed in comparisons, not
# in orientations, keeps the tuner's work the same whatever the image count.
SPAN_COMPARISONS = 1024 * 8 * 64


def _cache_path() -> str:
    return os.environ.get(
        "BIOEM_TPU_AUTOTUNE_CACHE", os.path.join(os.getcwd(), ".bioem_tpu_autotune.json")
    )


def _bucket(n: int) -> int:
    """Round to the NEAREST power of two (ratio distortion ≤ √2): the tuned
    winner depends on shape scale, not exact counts, so a run with 4500
    images reuses the entry tuned at 4096."""
    n = max(int(n), 1)
    hi = 1 << (n - 1).bit_length()
    lo = max(hi // 2, 1)
    return lo if n * n <= lo * hi else hi


def _device_kind(device=None) -> str:
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _cache_key(p, n_orient: int, n_img: int, cfg=None, device=None) -> str:
    forced = ""
    if cfg is not None and cfg.forced:
        # Forced knobs change which candidates are comparable — fold them
        # into the key so a forced run never poisons the free-tuning entry.
        forced = "|F" + ",".join(f"{f}={getattr(cfg, f)}" for f in sorted(cfg.forced))
    if cfg is not None and cfg.mesh_images * cfg.mesh_orient != 1:
        # a slot's shapes differ from the single device's: a mesh run must
        # never reuse (or poison) the single-device entry
        forced += f"|M{cfg.mesh_images}x{cfg.mesh_orient}"
    # BIOEM_DEBUG_BREAK caps n_ctf as well as n_orient: key at the CTF
    # count actually run, or a debug-capped tune poisons the production entry.
    return (
        f"torch|{_device_kind(device)}|N{p.n_pixels}|D{p.nx_disp}|s{p.grid_space_center}"
        f"|C{_n_ctf(p, cfg)}|I{_bucket(n_img)}|O{_bucket(n_orient)}{forced}"
    )


def _n_ctf(p, cfg=None) -> int:
    """The CTF count the engine runs (BIOEM_DEBUG_BREAK caps it)."""
    if cfg is not None and cfg.debug_break:
        return min(p.n_ctf, cfg.debug_break)
    return p.n_ctf


def _cache_load(key: str) -> Optional[dict]:
    try:
        with open(_cache_path()) as f:
            entry = json.load(f).get(key)
    except (OSError, ValueError, AttributeError):
        return None
    if not isinstance(entry, dict):
        return None
    return {k: v for k, v in entry.items() if k in _CACHED_FIELDS}


def _cache_store(key: str, fields: dict) -> None:
    path = _cache_path()
    try:
        data = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}  # unreadable cache = start fresh, never abort a run
            if not isinstance(data, dict):
                data = {}
        data[key] = fields
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, ValueError):
        pass  # the cache is an optimisation only


def k4_runs(p, device=None) -> bool:
    """K4 takes the problem: on the card where the kernel library has an
    instance for its lattice and the operands fit shared memory
    (``compare_cuda.batched_fits``; elsewhere the engine runs K1, so a K4
    candidate would time K1 twice); on the CPU always (its plain
    version)."""
    if resolve_device(device).type != "cuda":
        return True
    from ..core.posterior import stride_fold
    from ..ops.compare_cuda import batched_fits
    from ..params import displacement_lists

    disp, _ = displacement_lists(p)
    n = p.n_pixels
    return batched_fits(len(disp), n // stride_fold(p.grid_space_center, n, disp), p.n_fft_1d)


def default_candidates(cfg: RunConfig, p=None, device=None) -> List[RunConfig]:
    """Shape-derived candidate set (reference analogue: the autotuner's
    bisection domain, autotuner.cpp:118-149).

    On the kernel branch: orient_block ∈ {cfg.orient_block, 16} ×
    fused_lse ∈ {False, True} × fused_batched ∈ {False, True} (only with
    fused_lse, and only where :func:`k4_runs`), all at
    cfg.kernel_img_tile, which only pads the image count. On the plain
    branch only the orientation block matters: {4, 8, 16}. Forced knobs
    keep their value."""
    use_kernels = (cfg.use_kernels if cfg.use_kernels is not None
                   else resolve_device(device).type == "cuda")
    forced = cfg.forced
    if not use_kernels:
        o_blocks = (cfg.orient_block,) if "orient_block" in forced else (4, 8, 16)
        return [replace(cfg, autotune=False, orient_block=o, use_kernels=False)
                for o in o_blocks]
    o_blocks = ((cfg.orient_block,) if "orient_block" in forced
                else tuple(dict.fromkeys((cfg.orient_block, 16))))
    lse_variants = (cfg.fused_lse,) if "fused_lse" in forced else (False, True)
    batched_variants = (cfg.fused_batched,) if "fused_batched" in forced else (False, True)
    k4 = p is None or k4_runs(p, device)
    cands = []
    for o_block in o_blocks:
        for fused_lse in lse_variants:
            for fb in batched_variants:
                if fb and (fused_lse is False or not k4):
                    continue  # the batched body exists only with the fused LSE
                cands.append(replace(
                    cfg, autotune=False, use_kernels=True, orient_block=o_block,
                    fused_lse=fused_lse, fused_batched=fb,
                ))
    return cands


def _describe(c: RunConfig) -> str:
    return (f"o_block={c.orient_block} kernels={c.use_kernels} fused_lse={c.fused_lse} "
            f"fused_batched={c.fused_batched} tile={c.kernel_img_tile}")


def autotune_config(
    p,
    orients,
    model,
    images,
    cfg: RunConfig,
    candidates: Optional[Sequence[RunConfig]] = None,
    blocks: Optional[int] = None,
    repeats: int = 2,
    verbose: bool = False,
    device=None,
) -> RunConfig:
    """Pick the fastest RunConfig by timing real block steps per candidate
    (``BioEMEngine.time_blocks``); cached per (device kind, problem shape)."""
    from ..run import make_engine

    device = resolve_device(device)
    # Tune and key at the shape the engine will actually run (debug caps
    # applied), so a reduced run never poisons the production entry.
    n_orient = min(orients.n, cfg.debug_break) if cfg.debug_break else orients.n
    n_img = images.maps.shape[0]
    if cfg.debug_nmaps:
        n_img = min(n_img, cfg.debug_nmaps)
    key = _cache_key(p, n_orient, n_img, cfg, device)
    cached = _cache_load(key)
    if cached is not None:
        cached = {k: v for k, v in cached.items() if k not in cfg.forced}
        if verbose:
            print(f"autotune: cached config for {key}: {cached}")
        return replace(cfg, autotune=False, **cached)
    candidates = (list(candidates) if candidates is not None
                  else default_candidates(cfg, p=p, device=device))
    best_cfg, best_t = cfg, float("inf")
    # Same orientation span for every candidate (blocks is in units of the
    # baseline cfg.orient_block): SPAN_COMPARISONS by default.
    target_orients = (blocks * max(cfg.orient_block, 1) if blocks is not None
                      else min(n_orient, max(1, SPAN_COMPARISONS // (_n_ctf(p, cfg) * n_img))))
    for cand in candidates:
        t0 = time.perf_counter()
        try:
            eng = make_engine(p, orients, model, images, cand, device=device)
            t_setup = time.perf_counter() - t0
            t_cand = eng.time_blocks(target_orients, repeats=repeats)
        except (ValueError, torch.cuda.OutOfMemoryError) as e:
            if verbose:
                print(f"autotune: skip {_describe(cand)}: {e}")
            continue
        finally:
            eng = None
            if resolve_device(device).type == "cuda":
                torch.cuda.empty_cache()
        if verbose:
            print(f"autotune: {_describe(cand)}: {t_cand * 1e3:.4f} ms/orientation "
                  f"(engine set-up {t_setup:.3f} s, timing {time.perf_counter() - t0 - t_setup:.3f} s)")
        if t_cand < best_t:
            best_t, best_cfg = t_cand, cand
    if np.isfinite(best_t):
        # Only a timed winner is stored: an all-failed sweep must not make
        # the untuned fallback this shape's answer for good.
        _cache_store(key, {f: getattr(best_cfg, f) for f in _CACHED_FIELDS})
        if verbose:
            print(f"autotune: winner {_describe(best_cfg)} "
                  f"({best_t * 1e3:.4f} ms/orientation)")
    return best_cfg
