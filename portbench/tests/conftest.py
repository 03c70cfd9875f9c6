"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src`` on the path, and the cells cut to a size the CPU runs in a second
(the same files, with the vocabularies, the MLPs and the batches shrunk)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import spec  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN_CELLS = [c for c in CELLS if spec.load_cell(c, BENCH).mix["kind"] == "train"]
SCORE_CELLS = [c for c in CELLS if spec.load_cell(c, BENCH).mix["kind"] == "score"]


def tiny(name: str):
    """The cell ``name`` at a CPU test's size."""
    cell = copy.deepcopy(spec.load_cell(name, BENCH))
    cell.config.update(n_sparse=6, vocab_sizes=[64, 32, 100, 16, 8, 40], embed_dim=16,
                       bot_mlp=[32, 16], top_mlp=[64, 32, 1])
    cell.mix.update(rows=256, batches=4, trace_units=2)
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
