"""Checkpoint/resume of the streaming posterior accumulator.

PyTorch counterpart of ``bioem_tpu.runtime.checkpoint``, with the same
file layout, so a checkpoint written by either package resumes in the
other: an ``.npz`` holding ``__next_block`` (int64), ``__fingerprint``
(the problem fingerprint as uint8 bytes) and every non-None
``PosteriorState`` field under its own name. The reference has no
mid-run checkpointing (a crashed run restarts from scratch); here the
orientation loop is the resume point: (state, next block, fingerprint)
is saved every K blocks and resumed when the fingerprint matches.

Writes are atomic (tmp + rename), so a crash mid-write never corrupts the
last good checkpoint.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.posterior import PosteriorState

_FIELDS = PosteriorState._fields


def problem_fingerprint(p, orients, model, images, cfg) -> str:
    """Hash of everything that affects the accumulated state: the same
    tuple and arrays as the JAX package hashes (a single device is its
    1×1 mesh), so both return the same string on the same inputs."""
    h = hashlib.sha256()
    h.update(repr((
        p.n_pixels, p.pixel_size, p.n_ctf, p.max_displace_center,
        p.grid_space_center, p.write_angles, p.use_psf,
        cfg.orient_block, cfg.debug_break, cfg.debug_nmaps,
        getattr(cfg, "mesh_images", 1), getattr(cfg, "mesh_orient", 1),
    )).encode())
    h.update(np.ascontiguousarray(orients.angles).tobytes())
    h.update(np.ascontiguousarray(model.points).tobytes())
    h.update(np.ascontiguousarray(images.maps[:1]).tobytes())
    h.update(str(images.maps.shape).encode())
    return h.hexdigest()


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_checkpoint(path: str, state: PosteriorState, next_block: int, fingerprint: str) -> None:
    """Write ``state`` (torch tensors on any device, or NumPy arrays)."""
    arrays = {"__next_block": np.int64(next_block)}
    for name in _FIELDS:
        v = getattr(state, name)
        if v is not None:
            arrays[name] = _host(v)
    arrays["__fingerprint"] = np.frombuffer(fingerprint.encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(
    path: str, fingerprint: str, device=None
) -> Optional[Tuple[PosteriorState, int]]:
    """(state on ``device``, next_block) if a matching checkpoint exists,
    else None. The tensors are fresh copies: the engine updates the state
    in place."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stored = bytes(z["__fingerprint"]).decode()
            if stored != fingerprint:
                return None
            next_block = int(z["__next_block"])
            fields = {name: (z[name] if name in z.files else None) for name in _FIELDS}
    except (OSError, KeyError, ValueError):
        return None
    state = PosteriorState(**{
        k: (torch.tensor(v, device=device) if v is not None else None)
        for k, v in fields.items()
    })
    return state, next_block
