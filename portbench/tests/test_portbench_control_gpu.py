"""On the card: the control (the reference put in the program's place and
computed in TF32, the precision below the configurations' fp32) fails the
cell's limits, and a sound run of the program passes them, at the cell's
widths with its vocabularies capped at 100,000 rows and its batches cut to
a quarter. Skips without a card."""

import copy
import time

import pytest
import torch
from conftest import BENCH, CELLS

from portbench import controls, run, spec

SEED = 2_718_281_828


def quarter(name):
    cell = copy.deepcopy(spec.load_cell(name, BENCH))
    cell.config["vocab_sizes"] = [min(v, 100_000) for v in cell.config["vocab_sizes"]]
    cell.mix["rows"] //= 4
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    cell = quarter(name)
    find = controls.train_controls if cell.mix["kind"] == "train" else controls.score_controls
    readings = find(cell, SEED, card)
    assert any(readings["control"][k] > limit for k, limit in cell.limits.items())
    for fault, numbers in readings.items():
        assert any(numbers[k] > limit for k, limit in cell.limits.items()), fault
    line, _, _ = run.run_cell(cell, SEED, 1.0, False, card, time.perf_counter())
    assert line["correct"], line["check"]
