"""Golden-case accuracy of every engine configuration the port has.

The port's counterpart of the JAX package's ``tools/accuracy_probe.py``. A
golden case goes through the port's CLI under each configuration (the
plain branch; K1, the fused comparison; K4 forced; the hybrid: K3's cc
lattice and the torch log-sum-exp), and each row reports max |ΔlogP|
against the reference binary's f32 golden and, where the case has one, its
full-double golden (the external f64 truth). Both goldens are printed to 4
decimals, which floors those two columns at ~1e-4; so each row also holds
the engine, at full precision, to the all-f64 oracle
(``golden_error_budget.budget``), which the JAX tool does not: on the
case's own maps, and on the same maps normalised as the MRC ingest does.
The golden cases' text maps are DC-dominated, so the engine's f32 gate
sends K1 and K4 to the hybrid on them (the ``ran`` column says what ran);
the normalised maps open the gate, so those columns are where K1 and K4
meet the oracle. Each oracle gap is also given against the plain branch's
logP on the same maps, which places where a gap enters: the plain branch
against K1 against K4 against the hybrid.

The JAX tool's ``raw-log1p`` and ``masked-split`` rows set TPU-only knobs
(``BIOEM_TPU_ACCURATE_LOG1P``, ``BIOEM_TPU_SPLIT``: ``config.TPU_ONLY_ENV``),
which the port ignores; they are left out.

Usage (the card, or the CPU with ``BIOEM_TPU_FORCE_CPU=1``, where the
kernel configurations run their kernels' plain versions):

    python -m bioem_tpu_torch.tools.accuracy_probe [case]   (default case_n_n224)
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import sys
import tempfile

import numpy as np

from .golden_error_budget import DATA, budget, oracle_log_prob, parse_golden

# Environment of each configuration (config.RunConfig.from_env's names).
CONFIGS = {
    "plain": {"BIOEM_TPU_PALLAS": "0"},
    "K1": {"BIOEM_TPU_PALLAS": "1", "BIOEM_TPU_FUSED_LSE": "1"},
    "K4": {"BIOEM_TPU_PALLAS": "1", "BIOEM_TPU_FUSED_LSE": "1", "BIOEM_TPU_FUSED_BATCHED": "1"},
    "hybrid": {"BIOEM_TPU_PALLAS": "1", "BIOEM_TPU_FUSED_LSE": "0"},
}


@contextlib.contextmanager
def _environment(env: dict):
    """Every ``BIOEM_TPU_*`` name but the device switch and the autotune
    cache cleared, ``env`` and ``BIOEM_TPU_AUTOTUNE=0`` set; all restored."""
    keep = {"BIOEM_TPU_FORCE_CPU", "BIOEM_TPU_AUTOTUNE_CACHE"}
    saved = {k: v for k, v in os.environ.items() if k.startswith("BIOEM_TPU_")}
    for k in saved:
        if k not in keep:
            del os.environ[k]
    os.environ.update(env, BIOEM_TPU_AUTOTUNE="0")
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("BIOEM_TPU_")]:
            del os.environ[k]
        os.environ.update(saved)


def _cli_log_prob(case: str) -> np.ndarray:
    """The CLI's per-image LogProb of ``case`` in a temporary copy of it."""
    from ..cli import main as cli_main

    case_dir = os.path.join(DATA, case)
    maps = "maps.txt" if os.path.exists(os.path.join(case_dir, "maps.txt")) else "maps.mrc"
    extra = (["--ReadOrientation", "euler.txt"]
             if os.path.exists(os.path.join(case_dir, "euler.txt")) else [])
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        work = os.path.join(td, case)
        shutil.copytree(case_dir, work)
        os.chdir(work)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(["--Modelfile", "model.txt", "--Particlesfile", maps,
                               "--Inputfile", "param.txt", "--OutputFile", "out.probe", *extra])
            if rc != 0:
                raise RuntimeError(f"the CLI returned {rc} on {case}")
            return parse_golden("out.probe")
        finally:
            os.chdir(old)


def probe(case: str = "case_n_n224", configs=tuple(CONFIGS), device=None) -> list:
    """One row (a dict) per configuration: what ran on the case's maps and
    on the normalised maps, max |ΔlogP| of the CLI's output against the f32
    and f64 goldens (the latter nan where the case has none), and the
    engine's full-precision gap to the oracle and to the plain branch on
    both forms of the maps. ``device``: the budget's engine (the CLI takes
    the card, or the CPU with ``BIOEM_TPU_FORCE_CPU``)."""
    from ..config import RunConfig

    g32 = parse_golden(os.path.join(DATA, case, "Output_Probabilities.golden"))
    f64_path = os.path.join(DATA, case, "Output_Probabilities.f64.golden")
    g64 = parse_golden(f64_path) if os.path.exists(f64_path) else None
    oracle = {norm: oracle_log_prob(case, norm) for norm in (False, True)}
    plain = {}
    rows = []
    for name in ("plain", *[c for c in configs if c != "plain"]):
        with _environment(CONFIGS[name]):
            ours = _cli_log_prob(case)
            b = {norm: budget(case, RunConfig.from_env(), device, oracle[norm], norm)
                 for norm in (False, True)}
        if name == "plain":
            plain = {norm: b[norm].log_prob for norm in b}
        if name not in configs:
            continue
        gap = lambda a, r: float(np.max(np.abs(a - r)))  # noqa: E731
        rows.append({
            "config": name, "case": case, "n": b[False].n,
            "ran": b[False].comparison, "ran_normalized": b[True].comparison,
            "cli_vs_f32_golden": gap(ours, g32),
            "cli_vs_f64_golden": gap(ours, g64) if g64 is not None else float("nan"),
            "oracle_vs_f32_golden": b[False].orc_gold,
            "engine_vs_oracle": b[False].eng_orc,
            "engine_vs_oracle_normalized": b[True].eng_orc,
            "engine_vs_plain": gap(b[False].log_prob, plain[False]),
            "engine_vs_plain_normalized": gap(b[True].log_prob, plain[True]),
        })
    return rows


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    case = args[0] if args else "case_n_n224"
    for r in probe(case):
        print(f"{r['config']:<7} (ran {r['ran']:<6}; normalised: {r['ran_normalized']:<6}): "
              f"|d| vs f32 golden {r['cli_vs_f32_golden']:.4f}, vs f64 truth "
              f"{r['cli_vs_f64_golden']:.4f}; engine vs oracle {r['engine_vs_oracle']:.3e} "
              f"(vs plain {r['engine_vs_plain']:.3e}), normalised {r['engine_vs_oracle_normalized']:.3e} "
              f"(vs plain {r['engine_vs_plain_normalized']:.3e})", flush=True)
    print("PROBE DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
