"""bioem_tpu_torch — the PyTorch/CUDA port of bioem_tpu.

Bayesian inference of cryo-EM particle images (the capabilities of
bio-phys/BioEM): posterior probability of a structural model given
particle images, marginalised over orientation, CTF/PSF and
center-displacement nuisance grids with a numerically stable log-sum-exp,
plus maximizing-parameter tracking and per-orientation posteriors.

The package sits beside the JAX package ``bioem_tpu``, keeps its module
layout and names, and never imports JAX. On an NVIDIA Hopper card the
posterior's hot path runs hand-written CUDA kernels (``ops/``, built from
``csrc/`` at first use). The entry points take the card; asked for the CPU
(``device="cpu"`` or ``BIOEM_TPU_FORCE_CPU=1``) they run the plain torch
formulation there, and with neither and no card they raise.
"""

__version__ = "0.1.0"

from . import defs
from .config import RunConfig
from .params import BioEMParams, read_parameters
from .refine import RefineResult, refine_results

__all__ = ["defs", "RunConfig", "BioEMParams", "read_parameters", "RefineResult",
           "refine_results"]
