"""A run with the timed path broken underneath comes out not correct.

Each cell's run is driven on the CPU at a small size (the look for a card
is the only part left out; a multi-card cell runs as gloo ranks, with a
window of one step): a sound run is correct, and a run with each fault
the cell can have (``readings.faults``: a step that leaves the state
unchanged, the loss over half the batch, the exchange between cards left
out, an answer altered where it is produced) is not."""

import contextlib

import pytest
import torch

from posebench import harness, judge, readings
from posebench_tiny import CELLS, tiny

CASES = [(name, fault) for name in CELLS
         for fault in [None, *readings.faults(tiny(name))]]


def correct(cell, fault) -> bool:
    if cell.chips > 1:
        numbers = readings.train_program(cell, torch.device("cpu"), fault)
        return harness.passes(judge.checks(numbers, cell.workload["limits"]))
    with (readings.faults(cell)[fault]() if fault else
          contextlib.nullcontext()):
        out = harness.entry_module(cell.workload["entry"]).run(cell, 0.0)
    line = harness.result_line(cell, out, "cpu")
    assert list(line)[-1] == "checks"
    return line["correct"]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_is_not_correct(name, fault):
    assert correct(tiny(name), fault) is (fault is None)



@pytest.mark.parametrize("hit,expect", [
    ("deconv_2.0.weight", {"grad_gap_head": 0.2}),
    ("conv", {"grad_gap": 0.2}),
    ("bn", {"grad_gap_bn": 0.2})])
def test_a_fault_confined_to_one_group_shows_in_its_number(hit, expect):
    """A gradient 20% off in one group of parameters alone (one deconv's
    weights, every convolution, every BN) moves that group's number."""
    cell = tiny("sbp_train_b256")
    groups = cell.net.groups(cell.config)
    ones = {k: 1.0 for k in groups}
    ref = {"losses": [1.0], "logits": torch.ones(2, 3), "groups": groups,
           "grad_norms": ones, "change_norms": ones}
    prog = dict(ref, grad_norms={
        k: 1.2 if hit in (k, groups[k]) else 1.0 for k in groups})
    numbers = judge.train_numbers(prog, ref)
    for name in ("grad_gap", "grad_gap_head", "grad_gap_bn"):
        assert numbers[name] == pytest.approx(expect.get(name, 0.0))
