"""One engine ranks candidate models against one image set, as
``rank.rank_models`` does: the models share one layout
(``rank.common_model_layout``), so one captured block step serves them all,
and each pass swaps one candidate in (``eng.swap_model``) and scores it.

Set-up builds the engine on the layout and runs the first two candidates
(the capture, then the first swap); the window cycles on through the
candidates. A pass is the swap, ``eng.run(banks=...)``, a synchronise and
``eng.results()``; the swap's host seconds go to ``run.swap_s``.
"""

from __future__ import annotations

import time

from benchmark.port import Session, inputs


class RankCycle(Session):
    def __init__(self, prob, device, run):
        from bioem_tpu_torch.config import RunConfig
        from bioem_tpu_torch.rank import common_model_layout
        from bioem_tpu_torch.run import make_engine

        super().__init__(run, device)
        p, orients, self.models, images = inputs(prob)
        cfg = RunConfig()
        layout = common_model_layout(p, self.models, cfg.projection)
        t0 = time.perf_counter()
        self.eng = make_engine(p, orients, self.models[0], images, cfg, device=self.device,
                               model_layout=layout)
        run.engine_build_s = time.perf_counter() - t0
        self.next = 0
        run.first_pass_s = self._candidate()[0]
        self._candidate()

    def _candidate(self) -> tuple:
        """Swap the next candidate in and score it: (pass s, swap s)."""
        from torch.autograd.profiler import record_function

        m = self.next
        self.next = (m + 1) % len(self.models)
        t0 = time.perf_counter()
        with record_function("bench.swap_model"):
            banks = self.eng.banks if m == 0 else self.eng.swap_model(self.models[m])
        swap = time.perf_counter() - t0
        return swap + self.scored(m, banks, f"model:{m}"), swap

    def one_pass(self):
        dt, swap = self._candidate()
        self.run.pass_s.append(dt)
        if self.next != 1:  # model 0 runs on the engine's own banks
            self.run.swap_s.append(swap)


def start(prob, mix, device, run):
    return RankCycle(prob, device, run)
