"""Performance configuration (never changes results).

The PyTorch port's counterpart of ``bioem_tpu.config.RunConfig``: the
reference separates physics parameters (keyword file) from performance
knobs (env vars, reference bioem.cpp:97-138). The port reads the same
``BIOEM_*`` environment names as the JAX package. Every name the JAX
package reads is in exactly one of two sets below: honoured here
(:data:`HONOURED_ENV`), or ignored by design because it only steers the
TPU or JAX (:data:`TPU_ONLY_ENV`). The JAX package's
``use_pallas``/``pallas_img_tile``/``pallas_projection`` are
``use_kernels``/``kernel_img_tile``/``kernel_projection`` here.

:func:`resolve_device` is the one place where an entry point without an
explicit device picks one: the card, or the CPU only when asked.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import FrozenSet, Optional


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
    # Autotune block sizes and the comparison kernel before the main run.
    # None = auto: on when the problem has at least
    # run.AUTOTUNE_MIN_COMPARISONS comparisons. BIOEM_TPU_AUTOTUNE=0/1 forces.
    autotune: Optional[bool] = None
    # Run the hand-written CUDA kernels (True) or the plain torch branch
    # (False). None = auto: kernels on a CUDA device, plain on the CPU —
    # the JAX package's use_pallas = (backend == "tpu").
    use_kernels: Optional[bool] = None
    # Images per block of the batched comparison kernel (K4), as
    # pallas_img_tile is the JAX kernel's image tile; on the kernel branch
    # it is also the image padding granularity. K1 runs one block per
    # (orientation·ctf, image) and needs no tile. A K4 tile that does not
    # fit the kernel's shared memory is clamped down unless forced.
    kernel_img_tile: int = 32
    # Displacement log-sum-exp inside the comparison kernel (K1/K4, True)
    # or over the cc lattice of K3 in torch (the hybrid, False). None =
    # True on the kernel branch (the JAX package's default on its kernel
    # backend).
    fused_lse: Optional[bool] = None
    # Checkpoint/resume of the streaming accumulator state.
    checkpoint_path: str = ""
    checkpoint_every: int = 0  # orientation blocks between checkpoints (0 = 16)
    # torch.profiler Chrome-trace output directory; empty = off.
    profile_dir: str = ""
    # Projection backend: "auto" (Fourier when the model has <= 32 distinct
    # radii, else raster), "fourier", or "raster".
    projection: str = "auto"
    # The projection through its CUDA kernels (G3 and K2 on the Fourier path,
    # G4 on the raster) or the plain torch projection. None = follows
    # use_kernels. BIOEM_TPU_PROJ_PALLAS=0/1 forces.
    kernel_projection: Optional[bool] = None
    # The image-batched comparison kernel (K4) instead of K1 when the
    # log-sum-exp is fused. BIOEM_TPU_FUSED_BATCHED=0/1 forces.
    fused_batched: bool = False
    # (images × orientations) device mesh (parallel/mesh.py); 1×1 = the
    # single-device engine.
    mesh_images: int = 1
    mesh_orient: int = 1
    # Tuned fields the user pinned explicitly (env var or caller): the
    # autotuner never overrides these (performance knobs are obeyed
    # verbatim, reference doc/index.rst:1535-1653).
    forced: FrozenSet[str] = field(default_factory=frozenset)

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
            "BIOEM_TPU_CHECKPOINT_EVERY": "checkpoint_every",
            "BIOEM_TPU_MESH_IMAGES": "mesh_images",
            "BIOEM_TPU_MESH_ORIENT": "mesh_orient",
        }
        forced = set()
        tunable = {"orient_block", "image_block", "kernel_img_tile"}
        for env, attr in mapping.items():
            v = os.environ.get(env)
            if v is not None:
                setattr(cfg, attr, int(v))
                if attr in tunable:
                    forced.add(attr)
        cfg.checkpoint_path = os.environ.get("BIOEM_TPU_CHECKPOINT", "")
        cfg.profile_dir = os.environ.get("BIOEM_TPU_PROFILE_DIR", "")
        cfg.projection = os.environ.get("BIOEM_TPU_PROJECTION", "auto")
        if os.environ.get("BIOEM_TPU_AUTOTUNE"):
            cfg.autotune = bool(int(os.environ["BIOEM_TPU_AUTOTUNE"]))
        switches = {
            "BIOEM_TPU_PALLAS": "use_kernels",
            "BIOEM_TPU_PROJ_PALLAS": "kernel_projection",
            "BIOEM_TPU_FUSED_BATCHED": "fused_batched",
            "BIOEM_TPU_FUSED_LSE": "fused_lse",
        }
        for env, attr in switches.items():
            if os.environ.get(env):
                setattr(cfg, attr, bool(int(os.environ[env])))
                forced.add(attr)
        cfg.forced = frozenset(forced)
        return cfg


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when the caller names
    one; else the CPU when ``BIOEM_TPU_FORCE_CPU`` is set to any non-empty
    value (the JAX package's switch, read as it reads it); else the card.
    With neither and no CUDA device it raises rather than fall back to the
    CPU: a run that silently left the card would take the plain branch and
    report a CPU time as the card's."""
    import torch

    if device is not None:
        return torch.device(device)
    if os.environ.get("BIOEM_TPU_FORCE_CPU"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: bioem_tpu_torch runs on the card; to run on the CPU "
            "pass device='cpu' or set BIOEM_TPU_FORCE_CPU=1"
        )
    return torch.device("cuda")


# Every BIOEM_* name the JAX package reads, in exactly one of two sets.
# Honoured: RunConfig.from_env above, resolve_device, the autotuner's cache
# path, the DEBUG_PROB dump (debug_prob.maybe_dump_from_env), the native
# ingest (runtime/native.py) and the multi-process bootstrap
# (parallel/distributed.initialize).
HONOURED_ENV = frozenset({
    "BIOEM_DEBUG_BREAK", "BIOEM_DEBUG_NMAPS", "BIOEM_DEBUG_OUTPUT",
    "BIOEM_TPU_ORIENT_BLOCK", "BIOEM_TPU_IMAGE_BLOCK", "BIOEM_TPU_PALLAS_IMG_TILE",
    "BIOEM_TPU_CHECKPOINT", "BIOEM_TPU_CHECKPOINT_EVERY", "BIOEM_TPU_PROFILE_DIR",
    "BIOEM_TPU_PROJECTION", "BIOEM_TPU_AUTOTUNE", "BIOEM_TPU_AUTOTUNE_CACHE",
    "BIOEM_TPU_PALLAS", "BIOEM_TPU_PROJ_PALLAS", "BIOEM_TPU_FUSED_BATCHED",
    "BIOEM_TPU_FUSED_LSE", "BIOEM_TPU_FORCE_CPU",
    "BIOEM_TPU_DEBUG_PROB", "BIOEM_TPU_DEBUG_PROB_FILE", "BIOEM_TPU_DEBUG_PROB_KERNEL",
    "BIOEM_TPU_MESH_IMAGES", "BIOEM_TPU_MESH_ORIENT", "BIOEM_TPU_NATIVE_IO",
    "BIOEM_TPU_COORDINATOR", "BIOEM_TPU_NUM_PROCESSES", "BIOEM_TPU_PROCESS_ID",
})

# Ignored by design: they steer the TPU or JAX, which the port does not use.
TPU_ONLY_ENV = {
    "BIOEM_TPU_MXU_PRECISION": "TPU matmul precision workaround (3-pass bf16); the "
                               "port's kernels hold f32 accuracy by FMA or 3xTF32",
    "BIOEM_TPU_SPLIT": "TPU bf16 hi/lo split variant",
    "BIOEM_TPU_ACCURATE_LOG1P": "TPU log1p workaround; the port uses a true log1p",
    "BIOEM_TPU_NO_X64": "JAX x64 switch; the port keeps probabilities in f64 always",
}
