"""The comparison's control, the reference with float8 convolutions in
the program's place, fails where the program passes.

On the card at each cell's own size and limits (three seeds); on the CPU
at a small size, where its gaps exceed the program's in float32."""

import pytest
import torch

from posebench import harness, readings
from posebench_tiny import CELLS as TINY_CELLS, tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
ONE_CARD = [name for name in TINY_CELLS if tiny(name).chips == 1]
FIRST = {"train": "loss_gap", "infer": "peak_gap"}


@pytest.mark.parametrize("name", ONE_CARD)
def test_control_exceeds_the_program_at_a_small_size(name):
    cell = tiny(name)
    program, control = readings.SIDES[cell.workload["entry"]]
    key = FIRST[cell.workload["entry"]]
    got = program(cell, torch.device("cpu"))[key]
    ctl = control(cell, torch.device("cpu"))[key]
    assert ctl > 5 * got


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits_on_the_card(name, card):
    cell = harness.load_cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    limits = cell.workload["limits"]
    rows = readings.readings(cell, [2147483911, 2147483912, 2147483913],
                             3, 0, card, emit=lambda s: None)
    for row in rows:
        over = [k for k in limits if row[k] > limits[k]]
        if row["side"] == "control":
            assert over, row
        else:
            assert not over, row
