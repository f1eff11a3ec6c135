"""The check's control comes out not correct.

The control is the plain reference put in the program's place with the
two contractions of its cross-correlation in TF32 (operands rounded to a
10-bit mantissa, sums in float32), the step below the float32-with-TF32-off
that the configurations state. On the card, at the cells' own sizes, it
reads 100–300 times the program's gaps (PERF.md §6, PR 19); here, at a
size the CPU holds, it must still fail every cell's limits while the
program's own CPU path passes them.
"""

import os

import pytest
import torch

from benchmark import calibrate, harness, problem
from benchmark.registry import reference

CELLS = ["refgrid224.set64", "refgrid224.rank2x20"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_tf32_control_fails_every_cells_limits(cell_of, seed):
    cell = cell_of("refgrid224.set64", n=128, n_images=8)
    prob = problem.build(cell.cfg, cell.mix, seed)
    judged = harness.judge(prob, calibrate.control_outputs(prob, "cpu"), "cpu")
    for name in CELLS:
        limits = harness.load_json(os.path.join(harness.HERE, "limits", f"{name}.json"))
        correct, failed, rows = harness.verdict(judged, limits)
        assert not correct and failed >= 1, (name, rows)


def test_the_program_passes_at_the_controls_size(cell_of):
    out = harness.run_cell(cell_of("refgrid224.set64", n=128, n_images=8), 1, 0.1, False, "cpu", 0.0)
    assert out["result"]["correct"], out["result"]["checks"]


def test_tf32_rounding_by_hand():
    ref = reference({"reference": "bioem_posterior"})
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -12)])
    # ties go to even: 1 + 2^-11 → 1, 1 + 3·2^-11 → 1 + 2^-9; 2^-10 is kept
    expect = torch.tensor([1.0, 1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10, -1.0])
    assert torch.equal(ref._tf32(x), expect)


@pytest.mark.cuda
def test_tf32_emulation_equals_the_cards_tf32_matmul():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref = reference({"reference": "bioem_posterior"})
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(64, 256, device="cuda", generator=g)
    b = torch.randn(256, 64, device="cuda", generator=g)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        card = a @ b
        torch.backends.cuda.matmul.allow_tf32 = False
        emulated = ref._tf32(a) @ ref._tf32(b)
        exact = (a.double() @ b.double())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    err_card = (card.double() - exact).abs().max().item()
    err_emul = (emulated.double() - exact).abs().max().item()
    # the same error from the exact product, and far above float32's
    assert err_emul == pytest.approx(err_card, rel=0.5)
    assert err_card > 100 * (a @ b - exact.float()).abs().max().item()
