"""Attribute a golden case's log(P) gap: the port's f32 error against the
reference binary's.

The port's counterpart of the JAX package's ``tools/golden_error_budget.py``.
The all-f64 oracle (``tools/oracle.py``, a double-precision transliteration
of the reference math) splits the gap the golden tests see:

    Δ(engine, golden) ≤ Δ(engine, oracle) + Δ(oracle, golden)

* Δ(oracle, golden): the reference binary's own float32 pixel-path error at
  this N (its ``myfloat_t`` is float). No engine can beat it against that
  golden.
* Δ(engine, oracle): the port's true numerical error (f32 FFT banks, the
  comparison kernel's 3xTF32 products and f32 log1p, the stride-folded
  lattice).

The JAX suite holds its engine to Δ(engine, oracle) < 2e-5 at N = 64 and
5e-6 at N = 224, and to 50× inside Δ(oracle, golden)
(``tests/test_golden.py``, ``test_engine_beats_reference_precision``).

Usage (the card, or the CPU with ``BIOEM_TPU_FORCE_CPU=1``):

    python -m bioem_tpu_torch.tools.golden_error_budget [case ...]

(default: ``case_l_n64 case_n_n224``). The engine's configuration comes from
the ``BIOEM_*`` environment (``RunConfig.from_env``), e.g.
``BIOEM_TPU_PALLAS=0`` for the plain branch or ``BIOEM_TPU_FUSED_LSE=0``
for the hybrid.
"""

from __future__ import annotations

import os
import re
import sys
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "tests", "golden", "data")


class Budget(NamedTuple):
    case: str
    n: int  # pixels per side
    # max |engine − f32 golden|, the golden tests' metric (nan: normalised)
    eng_gold: float
    # max |oracle − f32 golden|, the reference's own error (nan: normalised)
    orc_gold: float
    eng_orc: float  # max |engine − oracle|, the port's true error
    comparison: str  # what the engine ran: plain, K1, K4 or hybrid
    log_prob: np.ndarray  # the engine's per-image logP


def parse_golden(path: str) -> np.ndarray:
    """The per-image LogProb column of an Output_Probabilities file."""
    vals = {}
    with open(path) as f:
        for line in f.read().splitlines():
            m = re.match(r"RefMap: (\d+) LogProb:\s+(\S+)", line)
            if m:
                vals[int(m.group(1))] = float(m.group(2))
    return np.array([vals[i] for i in range(len(vals))])


def load_case(case_dir: str, normalized: bool = False):
    """(params, orientations, model, images) of a golden case with text maps;
    ``normalized``: each map normalised as the MRC ingest does."""
    from ..core.orientations import build_orientations
    from ..io.map_io import ImageStack, _normalize_stack, read_ref_maps
    from ..io.model_io import read_model
    from ..params import read_parameters

    ang = os.path.join(case_dir, "euler.txt")
    p = read_parameters(os.path.join(case_dir, "param.txt"),
                        not_uniform_angles=os.path.exists(ang))
    images = read_ref_maps(os.path.join(case_dir, "maps.txt"), p.n_pixels,
                           normalize=not p.no_map_norm)
    model = read_model(os.path.join(case_dir, "model.txt"), pixel_size=p.pixel_size,
                       center_mass=not p.no_center_mass)
    orients = build_orientations(p, ang if os.path.exists(ang) else None)
    if normalized:
        images = ImageStack(_normalize_stack(images.maps))
    return p, orients, model, images


def comparison_of(eng) -> str:
    """The comparison an engine's block step runs."""
    if not eng.use_kernels:
        return "plain"
    if not (eng.fused_lse and eng._f32_corr_ok):
        return "hybrid"
    return "K4" if eng.fused_batched else "K1"


def oracle_log_prob(case: str, normalized: bool = False) -> np.ndarray:
    """The f64 oracle's per-image logP of a golden case."""
    from .oracle import run_oracle

    p, orients, model, images = load_case(os.path.join(DATA, case), normalized)
    res = run_oracle(p, orients, model.points.astype(np.float64),
                     model.radii.astype(np.float64), model.densities.astype(np.float64),
                     model.norm_den, images.maps)
    return res.log_prob


def budget(case: str, cfg=None, device=None, lp_oracle=None,
           normalized: bool = False) -> Budget:
    """The three gaps of ``case`` for the port's engine under ``cfg``
    (default ``RunConfig.from_env()``; make_engine never autotunes) on
    ``device`` (None: the card, or the CPU with ``BIOEM_TPU_FORCE_CPU``).
    ``lp_oracle``, the oracle's logP of the case, saves recomputing it.

    The golden cases' text maps are not normalised and are DC-dominated, so
    the engine's f32 gate (``core.engine.f32_corr_gate``) sends every kernel
    configuration to the hybrid there. ``normalized`` runs the case with
    each map normalised as the MRC ingest does: the gate opens and K1 and
    K4 run, held to the oracle on the same maps; no golden exists for
    those maps, so both golden gaps are nan."""
    from ..config import RunConfig
    from ..run import make_engine

    case_dir = os.path.join(DATA, case)
    p, orients, model, images = load_case(case_dir, normalized)
    lp_gold = (np.nan if normalized else
               parse_golden(os.path.join(case_dir, "Output_Probabilities.golden")))
    if lp_oracle is None:
        lp_oracle = oracle_log_prob(case, normalized)
    cfg = cfg or RunConfig.from_env()
    eng = make_engine(p, orients, model, images, cfg, device=device)
    lp_eng = eng.results(eng.run()).log_prob
    gap = lambda a, b: float(np.max(np.abs(a - b)))  # noqa: E731
    return Budget(case, p.n_pixels, gap(lp_eng, lp_gold), gap(lp_oracle, lp_gold),
                  gap(lp_eng, lp_oracle), comparison_of(eng), lp_eng)


def main(argv=None) -> int:
    cases = (sys.argv[1:] if argv is None else argv) or ["case_l_n64", "case_n_n224"]
    rows = []
    for c in cases:
        b = budget(c)
        rows.append(b)
        print(f"{c} (N={b.n}, comparison {b.comparison}):")
        print(f"  max |engine - golden| = {b.eng_gold:.3e}   (the golden-test metric)")
        print(f"  max |oracle - golden| = {b.orc_gold:.3e}   (reference's own f32 error)")
        print(f"  max |engine - oracle| = {b.eng_orc:.3e}   (the port's true f32 error)")
    print("\nN-scaling (quadrature law ~ N²·eps32):")
    for b in rows:
        print(f"  N={b.n:4d}: engine-vs-oracle/N² = {b.eng_orc / b.n**2:.2e}, "
              f"oracle-vs-golden/N² = {b.orc_gold / b.n**2:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
