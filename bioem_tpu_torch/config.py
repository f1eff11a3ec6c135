"""Performance configuration (never changes results).

The PyTorch port's subset of ``bioem_tpu.config.RunConfig``: the
reference separates physics parameters (keyword file) from performance
knobs (env vars, reference bioem.cpp:97-138). The port reads the same
``BIOEM_*`` environment names as the JAX package for the settings the
single-device posterior path honours. Mesh, autotune, checkpoint and
profile settings are not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class RunConfig:
    # Orientations processed per device step (reference analogue:
    # BIOEM_PROJ_CONV_AT_ONCE, bioem.cpp:105-121).
    orient_block: int = 8
    # Images per step of the plain branch; 0 = sized from a memory budget.
    image_block: int = 0
    # Debug reductions (reference BIOEM_DEBUG_BREAK / BIOEM_DEBUG_NMAPS,
    # bioem.cpp:518-525, map.cpp:545-548).
    debug_break: int = 0  # cap on n_orientations and n_ctfs
    debug_nmaps: int = 0  # cap on images
    # Verbosity 0/1/2 (reference BIOEM_DEBUG_OUTPUT).
    debug_output: int = 0
    # Image padding granularity of the kernel branch (the JAX package's
    # pallas_img_tile; same environment name). The CUDA comparison kernel
    # itself runs one block per (orientation·ctf, image) and needs no tile.
    kernel_img_tile: int = 32
    # Projection backend: "auto" (Fourier when the model has <= 32 distinct
    # radii, else raster), "fourier", or "raster".
    projection: str = "auto"
    # Run the hand-written CUDA kernels (True) or the plain torch branch
    # (False). None = auto: kernels on a CUDA device, plain on the CPU —
    # the JAX package's use_pallas = (backend == "tpu").
    use_kernels: Optional[bool] = None

    @classmethod
    def from_env(cls) -> "RunConfig":
        cfg = cls()
        mapping = {
            "BIOEM_TPU_ORIENT_BLOCK": "orient_block",
            "BIOEM_TPU_IMAGE_BLOCK": "image_block",
            "BIOEM_DEBUG_BREAK": "debug_break",
            "BIOEM_DEBUG_NMAPS": "debug_nmaps",
            "BIOEM_DEBUG_OUTPUT": "debug_output",
            "BIOEM_TPU_PALLAS_IMG_TILE": "kernel_img_tile",
        }
        for env, attr in mapping.items():
            v = os.environ.get(env)
            if v is not None:
                setattr(cfg, attr, int(v))
        cfg.projection = os.environ.get("BIOEM_TPU_PROJECTION", "auto")
        return cfg


# Environment settings of the JAX package that the port does not honour
# yet. The CLI refuses them rather than silently running something else.
NOT_PORTED_ENV = {
    "BIOEM_TPU_MESH_IMAGES": "the device mesh",
    "BIOEM_TPU_MESH_ORIENT": "the device mesh",
    "BIOEM_TPU_CHECKPOINT": "checkpoint/resume",
    "BIOEM_TPU_DEBUG_PROB": "the DEBUG_PROB per-evaluation dump",
}


def not_ported_env() -> list[str]:
    """Names of set environment variables whose feature is not ported.
    A mesh of 1×1 is the single device the port runs on, so it passes."""
    bad = []
    for name, what in NOT_PORTED_ENV.items():
        v = os.environ.get(name)
        if v is None or v == "":
            continue
        if name.startswith("BIOEM_TPU_MESH_") and v.strip() == "1":
            continue
        bad.append(f"{name} ({what})")
    return bad
