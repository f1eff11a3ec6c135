"""Carry the JAX package's parameters and state across to the port.

``banks_from_numpy`` takes the JAX engine's precomputed banks as NumPy
arrays,

    fields = {k: np.asarray(v) for k, v in jax_engine.banks._asdict().items()}
    banks = banks_from_numpy(fields, device)

and ``state_from_numpy`` a PosteriorState the same way, so the port's
block step can run on exactly the JAX engine's inputs: a comparison then
isolates the device math from the host precompute. The port's own engine
builds its banks through the same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.engine import Banks
from .core.posterior import PosteriorState


def _tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, copy=True, order="C"), device=device)


def banks_from_numpy(fields: Mapping[str, np.ndarray], device) -> Banks:
    """Banks on ``device`` from NumPy arrays, dtypes kept."""
    missing = set(Banks._fields) - set(fields)
    if missing:
        raise KeyError(f"banks_from_numpy: missing fields {sorted(missing)}")
    return Banks(**{k: _tensor(fields[k], device) for k in Banks._fields})


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> PosteriorState:
    """PosteriorState on ``device`` from NumPy arrays (absent per-angle
    slabs stay None), dtypes kept."""
    return PosteriorState(**{
        k: (_tensor(fields[k], device) if fields.get(k) is not None else None)
        for k in PosteriorState._fields
    })


def state_to_numpy(state: PosteriorState) -> dict:
    """The inverse of :func:`state_from_numpy`."""
    return {
        k: (v.detach().cpu().numpy() if v is not None else None)
        for k, v in state._asdict().items()
    }
