"""bioem_tpu_torch — the PyTorch/CUDA port of bioem_tpu.

Bayesian inference of cryo-EM particle images (the capabilities of
bio-phys/BioEM): posterior probability of a structural model given
particle images, marginalised over orientation, CTF/PSF and
center-displacement nuisance grids with a numerically stable log-sum-exp,
plus maximizing-parameter tracking and per-orientation posteriors.

The package sits beside the JAX package ``bioem_tpu``, keeps its module
layout and names, and never imports JAX. On an NVIDIA Hopper card the
posterior's hot path runs hand-written CUDA kernels (``ops/``, built from
``csrc/`` at first use); on the CPU it runs the plain torch formulation.
"""

__version__ = "0.1.0"

from . import defs
from .config import RunConfig
from .params import BioEMParams, read_parameters

__all__ = ["defs", "RunConfig", "BioEMParams", "read_parameters"]
