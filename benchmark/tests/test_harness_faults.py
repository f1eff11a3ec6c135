"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run on the CPU (the program's plain branch, a
problem the CPU holds; ``run_cell`` skips ``run.py``'s look for a card)
with one fault planted in the program, and sees ``correct`` false. The
faults are those a cell of this benchmark can have: a step that returns
its state unchanged; half of the work left out (every other orientation
block skipped, the posterior summed over the rest); an answer altered
where it is produced (one image's log P, or its best orientation). The
cells run on one chip, so there is no exchange between chips to leave out.
"""

import os

import numpy as np
import pytest

from benchmark import harness
from bioem_tpu_torch.core import engine as engine_mod

LIMIT_FILES = [os.path.join(harness.HERE, "limits", f) for f in os.listdir(os.path.join(harness.HERE, "limits"))]
ORIGINAL_STEP = engine_mod.BioEMEngine._block_step
ORIGINAL_RESULTS = engine_mod.BioEMEngine.results


def unchanged(self, state, *args, **kwargs):
    return state


def half_the_blocks(self, state, banks, angles, offset, *args, **kwargs):
    if (int(offset) // self.o_block) % 2:
        return state
    return ORIGINAL_STEP(self, state, banks, angles, offset, *args, **kwargs)


def altered_log_prob(self, state, n_img=None):
    # twice the widest limit of the cells: an alteration the check must see
    res = ORIGINAL_RESULTS(self, state, n_img)
    res.log_prob = res.log_prob.copy()
    res.log_prob[3] += 2 * max(max(harness.load_json(p).values()) for p in LIMIT_FILES)
    return res


def altered_orientation(self, state, n_img=None):
    res = ORIGINAL_RESULTS(self, state, n_img)
    res.best_orient = res.best_orient.copy()
    res.best_orient[3] = (res.best_orient[3] + 1) % self.n_orient
    return res


FAULTS = {
    "step_returns_state_unchanged": ("_block_step", unchanged),
    "half_of_the_blocks_left_out": ("_block_step", half_the_blocks),
    "log_p_altered_where_produced": ("results", altered_log_prob),
    "orientation_altered_where_produced": ("results", altered_orientation),
}


@pytest.mark.parametrize("cell_name", ["refgrid224.set64", "refgrid224.rank2x20"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell_of, monkeypatch, cell_name, fault):
    cell = cell_of(cell_name)
    attr, fn = FAULTS[fault]
    monkeypatch.setattr(engine_mod.BioEMEngine, attr, fn)
    out = harness.run_cell(cell, 991, 0.1, False, "cpu", 0.0)["result"]
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


def test_the_same_run_unbroken_is_correct(cell_of):
    out = harness.run_cell(cell_of("refgrid224.set64"), 991, 0.1, False, "cpu", 0.0)["result"]
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0


def test_limits_refuse_what_is_not_finite_or_unlimited():
    judged = {"numbers": {"logp_gap": float("nan"), "argmax_lp_gap": 0.0}, "per_pass": []}
    assert harness.verdict(judged, {"logp_gap": 1.0, "argmax_lp_gap": 1.0})[0] is False
    judged = {"numbers": {"logp_gap": 0.0, "new_gap": 0.0}, "per_pass": []}
    assert harness.verdict(judged, {"logp_gap": 1.0})[0] is False
    judged = {"numbers": {"logp_gap": 0.5}, "per_pass": [{"logp_gap": 0.5}]}
    assert harness.verdict(judged, {"logp_gap": 1.0}) == (True, 0, [("logp_gap", 0.5, 1.0)])
    assert np.isfinite(harness.verdict(judged, {"logp_gap": 0.1})[2][0][1])
    assert harness.verdict(judged, {"logp_gap": 0.1})[:2] == (False, 1)
