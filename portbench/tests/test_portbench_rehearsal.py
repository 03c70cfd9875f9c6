"""The whole run of each cell at a CPU test's size through the program's
plain paths, without the harness's look for a card: the result line has
the contract's keys, ``correct`` holds, and it comes out false with the
timed path broken underneath, once for each fault the cell can have."""

import json

import pytest
import torch
from conftest import SCORE_CELLS, TRAIN_CELLS, tiny

from portbench import run

SEED = 4_000_000_007
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _run(name, trace=False, seconds=0.5):
    line, cards, _ = run.run_cell(tiny(name), SEED, seconds, trace, torch.device("cpu"), 0.0)
    json.loads(json.dumps(line))
    return line


@pytest.mark.parametrize("name", TRAIN_CELLS + SCORE_CELLS)
def test_a_sound_run(name):
    line = _run(name)
    assert list(line) == KEYS
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    cell = tiny(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["check"]) == list(cell.limits)
    for v in line["check"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("name", TRAIN_CELLS[:1] + SCORE_CELLS[:1])
def test_a_traced_run(name):
    line = _run(name, trace=True)
    assert list(line) == KEYS[:5] + ["breakdown", "check"]
    names = {m["name"] for m in tiny(name).per_layer}
    assert set(line["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged_step(make):
    def make_faulty(cfg, opt, **kw):
        step, init = make(cfg, opt, **kw)

        def faulty(params, opt_state, batch):
            from repro_torch.models import recsys as R

            with torch.no_grad():
                loss = R.loss_fn(params, cfg, batch)
            return params, opt_state, {"loss": loss}
        return faulty, init
    return make_faulty


def _half_batch_step(make):
    def make_faulty(cfg, opt, **kw):
        step, init = make(cfg, opt, **kw)

        def faulty(params, opt_state, batch):
            n = batch["label"].shape[0] // 2
            return step(params, opt_state, {k: v[:n] for k, v in batch.items()})
        return faulty, init
    return make_faulty


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_faults_fail(name, fault, monkeypatch):
    from repro_torch.models import recsys as R

    monkeypatch.setattr(R, "make_sparse_train_step", fault(R.make_sparse_train_step))
    line = _run(name)
    assert not line["correct"]
    assert any(v["value"] is None or v["value"] > v["limit"] for v in line["check"].values())


def _altered_answer(serve):
    def faulty(params, cfg, batch):
        p = serve(params, cfg, batch)
        p[0] = 1.0 - p[0]
        return p
    return faulty


def _half_scored(serve):
    def faulty(params, cfg, batch):
        n = batch["sparse"].shape[0] // 2
        half = serve(params, cfg, {k: v[:n] for k, v in batch.items()})
        return torch.cat([half, half])
    return faulty


@pytest.mark.parametrize("fault", [_altered_answer, _half_scored],
                         ids=["answer_altered", "half_batch"])
@pytest.mark.parametrize("name", SCORE_CELLS)
def test_score_faults_fail(name, fault, monkeypatch):
    from repro_torch.models import recsys as R

    monkeypatch.setattr(R, "serve_step", fault(R.serve_step))
    line = _run(name)
    assert not line["correct"] and line["check"]["pctr_gap"]["value"] > 1e-2


def test_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal without one cannot be shown")
    assert run.main(["--workload", TRAIN_CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA card" in out.err


def test_main_refuses_an_unknown_cell(capsys):
    assert run.main(["--workload", "no-such.cell", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
