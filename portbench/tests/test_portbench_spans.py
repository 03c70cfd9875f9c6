"""The readers of the program's span metrics: None without the span, without
its device time or without the program's ``summary``; else the median over
the spans a planted tracer holds."""

import pytest
from conftest import BENCH

from portbench import spec

# metric -> (span, what it reads)
SPAN_METRICS = {
    "sparse_dedup_ms.train": ("sparse.dedup", "device_ms"),
    "sparse_gather_ms.train": ("sparse.gather", "device_ms"),
    "sparse_forward_ms.train": ("sparse.forward", "device_ms"),
    "sparse_backward_ms.train": ("sparse.backward", "device_ms"),
    "sparse_dense_opt_ms.train": ("sparse.dense_opt", "device_ms"),
    "sparse_rows_opt_ms.train": ("sparse.rows_opt", "device_ms"),
    "step_host_ms.train": ("train.step", "host_ms"),
    "serve_lookup_ms.score": ("embed.lookup", "device_ms"),
    "serve_host_ms.score": ("serve.step", "host_ms"),
}


class _Planted:
    """A resolved device time, as the tracer keeps one."""

    def __init__(self, ms):
        self._ms = ms

    def ms(self):
        return self._ms


@pytest.fixture
def tracer():
    from repro_torch.obs import trace as T

    t = T.Tracer(enabled=False)
    prev = T.set_tracer(t)
    try:
        yield t
    finally:
        T.set_tracer(prev)


def test_every_span_metric_is_in_the_benchmark():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        assert entries[name]["source"] == "program_span" and entries[name]["unit"] == "ms"


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_no_span_no_number(name, tracer):
    span, _ = SPAN_METRICS[name]
    read = spec.metric_reader(name)
    assert read(None) is None
    tracer._timed("other", 3_000_000, _Planted(1.0))
    assert read(None) is None
    tracer._timed(span, 2_000_000, None)            # host clock only: a CPU run
    assert read(None) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_the_median_of_a_planted_tracer(name, tracer):
    span, what = SPAN_METRICS[name]
    for host_ns, dev_ms in ((2_000_000, 5.0), (9_000_000, 1.0), (4_000_000, 3.0)):
        tracer._timed(span, host_ns, _Planted(dev_ms))
    want = 3.0 if what == "device_ms" else 4.0
    assert spec.metric_reader(name)(None) == want


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_program_without_summary_gives_none(name, monkeypatch):
    from repro_torch.obs import trace as T

    monkeypatch.setattr(T, "get_tracer", lambda: object())
    assert spec.metric_reader(name)(None) is None
