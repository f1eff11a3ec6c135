"""Per-phase wall-clock statistics (mean ± σ) and the profiler hook.

PyTorch counterpart of ``bioem_tpu.utils.timestat`` (the reference's
``HighResTimer``/``TimeStat``, timer.cpp:23-165, and its NVTX ranges,
bioem.cpp:53-91): the engine collects per-block step times here and
prints them like the reference's end-of-run phase table;
``profile_trace`` wraps a region in ``torch.profiler`` and writes a
Chrome trace (the NVTX analogue; open it in Perfetto or chrome://tracing).

Phases: BLOCK (one orientation-block step, host enqueue unless a
synchronise ends it) and CHECKPOINT (device → host copy and atomic write
of the streaming state).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class TimeStat:
    """Accumulates named phase durations; prints a mean±σ summary."""

    phases: Dict[str, List[float]] = field(default_factory=dict)

    def add(self, phase: str, seconds: float) -> None:
        self.phases.setdefault(phase, []).append(seconds)

    @contextlib.contextmanager
    def time(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(phase, time.perf_counter() - t0)

    def summary(self) -> str:
        """Reference timer.cpp:156-165 format: phase, total, mean, σ."""
        lines = ["\tTime statistics:"]
        for phase, vals in self.phases.items():
            n = len(vals)
            mean = sum(vals) / n
            var = sum((v - mean) ** 2 for v in vals) / n
            lines.append(
                f"\t\t{phase:<12} total {sum(vals):10.4f}s  "
                f"mean {mean:9.5f}s  stdev {math.sqrt(var):9.5f}s  (n={n})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """torch.profiler region (CPU, and CUDA where a card is present) that
    writes ``trace_dir/bioem_trace_<pid>.json``. No-op when empty."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"bioem_trace_{os.getpid()}.json"))
