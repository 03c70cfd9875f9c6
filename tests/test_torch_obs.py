"""The port's observability against the JAX package's, on the CPU.

* ``repro_torch.obs.validate`` gives JAX's verdict and summary on every
  validator case of ``tests/test_obs.py``, and its CLI fails on garbage;
* a trace the port's driver exports passes JAX's validator, and a trace
  the JAX driver exports passes the port's;
* ``fe.layer`` spans: per thread name, the args (``layer``, ``host_ops``,
  ``dispatches``) equal JAX's for the ``dlrm``, ``ads_ctr`` and ``bst``
  plans;
* the span and instant names on each thread of the JAX driver's streaming
  trace equal the port's on the same shards, less the names left out on
  purpose (ROADMAP A) and the threshold-gated wait spans, which each side
  records only when a wait was long; the JAX driver runs under JAX's
  tracer with its tracks keyed by thread, not by a reusable ident;
* ``run_unfused`` is bit for bit ``run_layers``, with JAX's dispatch
  counts; tracing changes no output bit.
"""

import json
import sys
import threading
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.core.metakernel import ExecutionStats as JaxExecutionStats  # noqa: E402
from repro.core.metakernel import run_unfused as jax_run_unfused  # noqa: E402
from repro.fe import featureplan as jax_featureplan  # noqa: E402
from repro.fe import get_spec as jax_get_spec  # noqa: E402
from repro.fe.datagen import gen_views as jax_gen_views  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.obs import validate as jax_validate  # noqa: E402

from repro_torch.core.metakernel import ExecutionStats, run_layers, run_unfused  # noqa: E402
from repro_torch.fe import featureplan, get_spec  # noqa: E402
from repro_torch.fe.datagen import gen_views, write_log_shards  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.obs import validate as port_validate  # noqa: E402

CPU = torch.device("cpu")
PLANS = ("dlrm", "ads_ctr", "bst")


def _ev(ph, ts, name, tid=0, **kw):
    return dict({"ph": ph, "pid": 1, "tid": tid, "ts": ts, "name": name}, **kw)


# the validator cases of tests/test_obs.py, each (trace, error match or None)
CASES = {
    "unopened E": ([_ev("E", 1.0, "x")], "no open B"),
    "misnested": ([_ev("B", 1.0, "a"), _ev("B", 2.0, "b"), _ev("E", 3.0, "a")],
                  "improper nesting"),
    "unmatched B": ([_ev("B", 1.0, "a")], "unmatched B"),
    "backwards": ([_ev("i", 5.0, "a", s="t"), _ev("i", 4.0, "b", s="t")], "ran backwards"),
    "per-track time": ([_ev("i", 5.0, "a", s="t"), _ev("i", 1.0, "b", tid=1, s="t")], None),
    "missing ph": ([{"name": "x"}], "missing ph"),
    "no traceEvents": ({"events": []}, "traceEvents"),
    "overlapping tracks": ([
        {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name", "args": {"name": "fe-worker"}},
        _ev("B", 0.0, "fe.x"), _ev("E", 100.0, "fe.x"),
        _ev("B", 60.0, "train.step", tid=1), _ev("C", 70.0, "q", tid=1, args={"q": 1}),
        _ev("E", 160.0, "train.step", tid=1)], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validator_gives_jaxs_verdict_and_summary(case):
    events, match = CASES[case]
    trace = events if isinstance(events, dict) else {"traceEvents": events}
    if match is None:
        want = jax_validate.validate_trace(trace)
        assert port_validate.validate_trace(trace) == want
        for a, b in (("fe.", "train."), ("fe.", "h2d.")):
            assert (port_validate.overlap_seconds(trace, a, b)
                    == jax_validate.overlap_seconds(trace, a, b))
        assert port_validate.span_intervals(trace) == jax_validate.span_intervals(trace)
        return
    for mod in (jax_validate, port_validate):
        with pytest.raises(mod.TraceError, match=match):
            mod.validate_trace(trace)


def test_validator_cli_fails_on_garbage_and_on_missing_requirements(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("not json{")
    assert port_validate.main([str(bad)]) == 1
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"traceEvents": CASES["overlapping tracks"][0]}))
    assert port_validate.main([str(good), "--require-overlap", "fe.", "train."]) == 0
    assert port_validate.main([str(good), "--require-tracks", "2"]) == 1
    assert port_validate.main([str(good), "--require-overlap", "fe.", "h2d."]) == 1
    assert "INVALID trace" in capsys.readouterr().err


# ------------------------------------------------------------- fe.layer
def _layer_spans(events, tracks):
    """[(thread name, layer, host_ops, dispatches)] of the fe.layer spans."""
    return [(tracks[e["tid"]], e["args"]["layer"], e["args"]["host_ops"],
             e["args"]["dispatches"])
            for e in events if e["ph"] == "B" and e["name"] == "fe.layer"]


def _traced(mod, fn):
    """Run ``fn`` under a fresh enabled tracer of ``mod``; its trace dict."""
    tracer = mod.Tracer(enabled=True)
    prev = mod.set_tracer(tracer)
    try:
        fn()
    finally:
        mod.set_tracer(prev)
    return tracer.to_dict()


def _tracks(trace):
    return {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}


@pytest.mark.parametrize("spec", PLANS)
def test_fe_layer_spans_match_jax(spec):
    jplan = jax_featureplan.compile(jax_get_spec(spec))
    plan = featureplan.compile(get_spec(spec))
    jt = _traced(jax_trace, lambda: jplan.run(jax_gen_views(64, seed=3)))
    pt = _traced(port_trace, lambda: plan.run(gen_views(64, seed=3), device=CPU))
    want = _layer_spans(jt["traceEvents"], _tracks(jt))
    got = _layer_spans(pt["traceEvents"], _tracks(pt))
    assert got == want and len(got) == len(plan.layers)
    jax_validate.validate_trace(pt)


@pytest.mark.parametrize("spec", PLANS)
def test_run_unfused_equals_run_layers_with_jaxs_counts(spec):
    plan = featureplan.compile(get_spec(spec))
    jplan = jax_featureplan.compile(jax_get_spec(spec))
    fused_stats, unfused_stats, jstats = ExecutionStats(), ExecutionStats(), JaxExecutionStats()
    fused = run_layers(plan.layers, dict(gen_views(96, seed=5)), device=CPU, stats=fused_stats)
    unfused = run_unfused(plan.layers, dict(gen_views(96, seed=5)), device=CPU,
                          stats=unfused_stats)
    jax_run_unfused(jplan.layers, dict(jax_gen_views(96, seed=5)), stats=jstats)
    for k in plan.output_slots:
        a, b = fused[k], unfused[k]
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for f in ("n_layers", "n_source_layers", "n_device_dispatches", "n_host_ops"):
        assert getattr(unfused_stats, f) == getattr(jstats, f), f
    assert unfused_stats.n_layers_coalesced == jstats.n_layers_coalesced
    assert unfused_stats.n_device_dispatches == sum(len(la.device_ops) for la in plan.layers)
    assert fused_stats.n_device_dispatches == sum(la.n_dispatches for la in plan.layers)
    m = unfused_stats.as_metrics()
    assert m["n_layers_coalesced"] == jstats.as_metrics()["n_layers_coalesced"]


@pytest.mark.parametrize("spec", PLANS)
def test_tracing_changes_no_output_bit(spec):
    plan = featureplan.compile(get_spec(spec))
    outs = []
    for enabled in (True, False):
        tracer = port_trace.Tracer(enabled=enabled)
        prev = port_trace.set_tracer(tracer)
        try:
            outs.append(plan.run(gen_views(64, seed=11), device=CPU))
        finally:
            port_trace.set_tracer(prev)
        assert (tracer.n_events > 0) == enabled
    on, off = outs
    for k in plan.output_slots:
        assert on[k].dtype == off[k].dtype and torch.equal(on[k], off[k]), k


# ------------------------------------------------------ the drivers' traces
# Wait spans each side records only past a threshold (a long wait), so a
# name may appear on one side and not the other.
GATED = {"train.wait_batch", "io.wait_shard", "io.backpressure", "h2d.reclaim_stall", "io.retry"}
DRIVER_ARGS = ["--arch", "dlrm-mlperf", "--gen-shards", "4", "--batch", "64", "--spec", "dlrm",
               "--device-feed", "arena", "--fault-tolerant", "--steps", "4"]


class _ThreadKeyedTracer(jax_trace.Tracer):
    """JAX's tracer with its tracks keyed by the ``Thread`` object, as the
    port keys them. JAX keys a track by ``threading.get_ident()``, and an
    ident is reused once its thread ends: a shard reader that exits before
    the runner starts its ``h2d-feeder`` hands the feeder its ident, and the
    feeder's spans land on the reader's track (ROADMAP C10). Every span and
    its time stay JAX's; only the track a thread's events go to is fixed."""

    def _track_locked(self):
        thread = threading.current_thread()
        entry = self._tracks.get(thread)
        if entry is None:
            entry = (len(self._tracks), thread.name)
            self._tracks[thread] = entry
        return entry[0]


@pytest.fixture(scope="module")
def driver_traces(tmp_path_factory):
    """The JAX driver's and the port's traces of the same streaming run."""
    d = tmp_path_factory.mktemp("trace")
    jpath, ppath = str(d / "jax.json"), str(d / "port.json")
    prev_argv, prev_j, prev_p = sys.argv, jax_trace.get_tracer(), port_trace.get_tracer()
    try:
        from repro.launch import train as JT
        sys.argv = ["train"] + DRIVER_ARGS + ["--data-dir", str(d / "j"), "--trace", jpath]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trace, "Tracer", _ThreadKeyedTracer)  # what enable_tracing installs
            JT.main()
        T.main(DRIVER_ARGS + ["--data-dir", str(d / "p"), "--device", "cpu", "--trace", ppath])
    finally:
        sys.argv = prev_argv
        jax_trace.set_tracer(prev_j)
        port_trace.set_tracer(prev_p)
    with open(jpath) as f, open(ppath) as g:
        return json.load(f), json.load(g), jpath, ppath


def _names_by_thread(trace):
    tracks = _tracks(trace)
    out = defaultdict(set)
    for e in trace["traceEvents"]:
        if e["ph"] in ("B", "i"):
            name = tracks[e["tid"]]
            # reader threads are numbered; a run may use any of them
            out["shard-reader" if name.startswith("shard-reader") else name].add(e["name"])
    return out


def test_each_driver_trace_passes_the_other_validator(driver_traces):
    jt, pt, jpath, ppath = driver_traces
    for trace, path in ((jt, jpath), (pt, ppath)):
        want = jax_validate.validate_trace(trace)
        assert port_validate.validate_trace(path) == want
        assert port_validate.main([path, "--require-tracks", "4",
                                   "--require-overlap", "fe.", "train."]) == 0


def test_span_names_per_thread_match_the_jax_driver(driver_traces):
    jt, pt, *_ = driver_traces
    want, got = _names_by_thread(jt), _names_by_thread(pt)
    assert set(got) == set(want)
    for thread in want:
        assert got[thread] - GATED == want[thread] - GATED, thread
    assert "fe.layer" in got["fe-worker"] and "train.adapt" in got["MainThread"]
    assert {"arena.rewind", "h2d.stage"} <= got["h2d-feeder"]
    # the fe.layer args per thread, as in JAX
    assert (_layer_spans(pt["traceEvents"], _tracks(pt))
            == _layer_spans(jt["traceEvents"], _tracks(jt)))
