"""The layer spans of the sparse train step and ``serve_step``.

* off (tracer disabled, no profiler session), every span a DLRM step, the
  training loop and ``serve_step`` ask for is the shared ``NULL_SPAN``, and
  nothing is recorded;
* under a ``torch.profiler`` session the spans are ranges of the profiler's
  own trace, nested as the work is (the six ``sparse.*`` spans in order
  inside ``train.step``, then ``train.loss_read``; ``embed.lookup`` inside
  ``serve.step``), and the tracer records them though it is not enabled;
* ``summary()`` gives each span's count and median host and device ms, the
  latter from CUDA events (faked here; real on the card), and the export
  carries the tracer's epoch on both clocks and each span's ``device_ms``.

This file imports neither JAX nor the JAX package; its ``gpu`` tests run on
the card with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_spans.py``.
"""

import dataclasses
import statistics
import time
import types

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.dlrm_mlperf import CONFIG, smoke  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_training  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402

CPU = torch.device("cpu")
# what a span reads of a CUDA tensor, for the CPU tests of the device path
ON_CARD = types.SimpleNamespace(device=torch.device("cuda"))
ON_CPU = torch.zeros(1)
SPARSE = ["sparse.dedup", "sparse.gather", "sparse.forward", "sparse.backward",
          "sparse.dense_opt", "sparse.rows_opt"]
SERVE = ["serve.step", "embed.lookup"]


@pytest.fixture
def tracer():
    """A fresh tracer, disabled, installed for the test."""
    t = T.Tracer(enabled=False)
    prev = T.set_tracer(t)
    try:
        yield t
    finally:
        T.set_tracer(prev)


class _Spy(T.Tracer):
    """A tracer that keeps what :meth:`span` answered, by name."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.answers = []

    def span(self, name, device=None, **args):
        got = super().span(name, device, **args)
        self.answers.append((name, got))
        return got


def _train(cfg, rows, device, steps, state=None):
    """``steps`` steps of the sparse DLRM step through ``run_training``;
    returns the state to go on from."""
    if state is None:
        params = R.init_params(cfg, torch.Generator(device=device).manual_seed(0))
        step, init = R.make_sparse_train_step(cfg, adamw(1e-3))
        state = {"params": params, "opt": init(params), "step": step}

    def train_step(st, batch):
        p, o, m = st["step"](st["params"], st["opt"], batch)
        st.update(params=p, opt=o)
        return st, m

    run_training(cfg=LoopConfig(n_steps=steps), state=state, train_step=train_step,
                 batch_source=lambda i: synthetic_batch("recsys", cfg, rows, i, device=device))
    return state


def test_off_every_span_is_the_null_span_and_nothing_is_recorded():
    spy = _Spy(enabled=False)
    prev = T.set_tracer(spy)
    try:
        state = _train(smoke(), 64, CPU, 2)
        R.serve_step(state["params"], smoke(), synthetic_batch("recsys", smoke(), 64, 7,
                                                               device=CPU))
    finally:
        T.set_tracer(prev)
    names = {n for n, _ in spy.answers}
    assert set(SPARSE + SERVE + ["train.loss_read"]) <= names
    assert all(got is T.NULL_SPAN for _, got in spy.answers)
    assert spy.n_events == 0 and spy.summary() == {}


def _ranges(prof, names):
    """The host ranges of ``names`` in the profiler's events, by start."""
    out = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
           if e.name in names and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(out)


def test_a_profiler_session_holds_the_spans_nested_as_the_work_is(tracer):
    cfg = smoke()
    state = _train(cfg, 64, CPU, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(cfg, 64, CPU, 2, state)
        R.serve_step(state["params"], cfg, synthetic_batch("recsys", cfg, 64, 9, device=CPU))
    got = _ranges(prof, set(SPARSE + SERVE + ["train.step", "train.loss_read"]))
    steps = [r for r in got if r[2] == "train.step"]
    reads = [r for r in got if r[2] == "train.loss_read"]
    assert len(steps) == 2 and len(reads) == 2
    for (a, b, _), read in zip(steps, reads):
        inside = [r for r in got if a <= r[0] and r[1] <= b and r[2] != "train.step"]
        assert [r[2] for r in inside] == SPARSE
        assert all(x[1] <= y[0] for x, y in zip(inside, inside[1:]))     # in turn
        assert b <= read[0]
    (sa, sb, _), = [r for r in got if r[2] == "serve.step"]
    (la, lb, _), = [r for r in got if r[2] == "embed.lookup"]
    assert sa <= la and lb <= sb
    # the tracer recorded them, on the host clock alone
    s = tracer.summary()
    loop = SPARSE + ["train.step", "train.loss_read"]
    assert {n: s[n]["count"] for n in loop} == dict.fromkeys(loop, 2)
    assert s["serve.step"]["count"] == s["embed.lookup"]["count"] == 1
    assert all(v["host_ms"] > 0 and v["device_ms"] is None for v in s.values())
    assert not tracer.enabled and tracer.n_events > 0


def test_the_export_carries_the_epoch_on_both_clocks():
    unix0 = time.time_ns()
    t = T.Tracer()
    unix1 = time.time_ns()
    with t.span("a"):
        pass
    d = t.to_dict()
    epoch = d["otherData"]
    assert unix0 <= epoch["epoch_unix_ns"] <= unix1
    b = next(e for e in d["traceEvents"] if e["ph"] == "B")
    assert b["ts"] == (t._events[0][2] - epoch["epoch_perf_counter_ns"]) / 1e3 >= 0
    t.clear()
    assert t.to_dict()["otherData"]["epoch_unix_ns"] >= epoch["epoch_unix_ns"]


class _FakeEvent:
    """``torch.cuda.Event`` on a planted clock: each record takes the next
    stamp of :attr:`STAMPS` (ms)."""

    STAMPS = []
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        self.at = type(self).STAMPS.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_timed_spans_give_the_median_of_their_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    # three spans: 2, 7 and 3 ms on the device; an untimed one of the same name
    monkeypatch.setattr(_FakeEvent, "STAMPS", [0.0, 2.0, 10.0, 17.0, 20.0, 23.0])
    t = T.Tracer()
    for _ in range(3):
        with t.span("work", device=ON_CARD):
            pass
    with t.span("work", device=ON_CPU):
        pass
    with t.span("host"):
        pass
    s = t.summary()
    assert s["work"]["count"] == 4 and s["work"]["device_ms"] == 3.0
    assert s["host"]["count"] == 1 and s["host"]["device_ms"] is None
    ends = [e for e in t.to_dict()["traceEvents"] if e["ph"] == "E" and e["name"] == "work"]
    assert [e.get("args", {}).get("device_ms") for e in ends] == [2.0, 7.0, 3.0, None]


def test_a_disabled_tracer_makes_cuda_events_only_in_a_profiler_session(monkeypatch, tracer):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "STAMPS", [1.0, 1.5])
    with tracer.span("work", device=ON_CARD) as span:
        assert span is T.NULL_SPAN
    assert _FakeEvent.made == 0 and tracer.n_events == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("work", device=ON_CARD):
            pass
    assert _FakeEvent.made == 2 and tracer.summary()["work"]["device_ms"] == 0.5


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _card_config():
    """DLRM at MLPerf's widths, every vocabulary capped at 500,000 rows."""
    return dataclasses.replace(CONFIG, vocab_sizes=tuple(min(v, 500_000)
                                                         for v in CONFIG.vocab_sizes))


CARD_ROWS = 32_768


@pytest.mark.gpu
def test_the_sparse_spans_split_the_step_on_the_card(cuda_device, tracer):
    cfg = _card_config()
    state = _train(cfg, CARD_ROWS, cuda_device, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _train(cfg, CARD_ROWS, cuda_device, 5, state)
        torch.cuda.synchronize()
    s = tracer.summary()
    parts = [s[n]["device_ms"] for n in SPARSE]
    assert all(ms is not None and ms > 0 for ms in parts), parts
    whole = s["train.step"]["device_ms"]
    assert abs(sum(parts) - whole) <= 0.05 * whole, (parts, whole)
    assert statistics.median([s[n]["count"] for n in SPARSE]) == 5


@pytest.mark.gpu
def test_a_step_with_tracing_off_makes_no_cuda_event(cuda_device, tracer, monkeypatch):
    made = []

    class Counted(torch.cuda.Event):
        def __new__(cls, *a, **k):
            made.append(1)
            return super().__new__(cls, *a, **k)

    cfg = _card_config()
    state = _train(cfg, 1024, cuda_device, 1)
    monkeypatch.setattr(torch.cuda, "Event", Counted)
    _train(cfg, 1024, cuda_device, 2, state)
    torch.cuda.synchronize()
    assert made == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _train(cfg, 1024, cuda_device, 1, state)
    assert len(made) == 2 * (len(SPARSE) + 2)      # the step, its six parts, the loss read
