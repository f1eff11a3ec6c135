"""One engine scores one image set again and again, as a batch job does:
every pass runs every orientation block of the configuration.

Set-up is the program's own entry (``run.maybe_autotune`` with its own
decision, ``run.make_engine``) and one pass, which captures the block step
on the card; each pass of the window is ``eng.run()``, a synchronise and
``eng.results()``.
"""

from __future__ import annotations

import time

from benchmark.port import Session, inputs


class RepeatPass(Session):
    def __init__(self, prob, device, run):
        from bioem_tpu_torch.config import RunConfig
        from bioem_tpu_torch.run import make_engine, maybe_autotune

        super().__init__(run, device)
        p, orients, models, images = inputs(prob)
        cfg = maybe_autotune(p, orients, models[0], images, RunConfig(), device=self.device)
        t0 = time.perf_counter()
        self.eng = make_engine(p, orients, models[0], images, cfg, device=self.device)
        run.engine_build_s = time.perf_counter() - t0
        run.first_pass_s = self.scored(0)

    def one_pass(self):
        self.run.pass_s.append(self.scored(0))


def start(prob, mix, device, run):
    return RepeatPass(prob, device, run)
