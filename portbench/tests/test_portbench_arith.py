"""The yardstick's arithmetic against numbers worked by hand: model FLOPs,
least times and roofline shares, the trace's busy union and gaps, the
percentile."""

import math
import types

import pytest
from conftest import BENCH

from portbench import devtrace, peaks, spec
from portbench.devtrace import Event


def _ctx(cell, window=None, trace=None):
    return types.SimpleNamespace(cell=cell, result=types.SimpleNamespace(window=window,
                                                                         trace=trace))


def test_forward_flops():
    # DLRM: bottom 13*512 + 512*256 + 256*128 = 170,496; the 351 pairs of 128: 44,928;
    # top (351 + 128)*1024 + 1024*1024 + 1024*512 + 512*256 + 256*1 = 2,194,688
    dlrm = spec.load_cell("dlrm-mlperf.train-zipf", BENCH)
    assert dlrm.model.forward_flops_per_row(dlrm.config) == 2 * 2_410_112
    score = spec.load_cell("dlrm-mlperf.score-bulk", BENCH)
    assert score.model.forward_flops_per_row(score.config) == 2 * 2_410_112


def test_least_time_and_peaks():
    assert peaks.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert peaks.peak_flops({"dtype": "float32", "tf32": False}) == 67e12


def test_step_mfu_by_hand():
    cell = spec.load_cell("dlrm-mlperf.train-zipf", BENCH)
    ctx = _ctx(cell, window={"units": 10, "seconds": 1.0, "rows": 65536})
    # 3 passes x 4,820,224 FLOPs x 655,360 rows = 9.4771e12 FLOP in 1 s of 67e12
    expect = 100 * 3 * 4_820_224 * 655_360 / 67e12
    assert spec.metric_reader("step_mfu.train")(ctx) == pytest.approx(expect)
    assert expect == pytest.approx(14.1449, rel=1e-4)
    score = spec.load_cell("dlrm-mlperf.score-bulk", BENCH)
    ctx = _ctx(score, window={"units": 2, "seconds": 0.1, "rows": 262144})
    assert spec.metric_reader("step_mfu.score")(ctx) == pytest.approx(
        100 * 4_820_224 * 524_288 / 0.1 / 67e12)


def _summary(kernels, units=4, window_s=1.0, busy_s=0.5):
    return devtrace.TraceSummary(units=units, window_s=window_s, busy_s=busy_s,
                                 kernels=kernels, idle_gaps=[])


def test_interaction_rooflines_by_hand():
    cell = spec.load_cell("dlrm-mlperf.train-zipf", BENCH)
    # B = 65,536, F = 27, D = 128, P = 351: 4 (B F D + B P) = 997,982,208 bytes,
    # 2 B P D = 5,888,802,816 FLOPs: bound by bytes, 0.297905 ms
    fwd = 997_982_208 / 3.35e12
    trace = _summary({"void dot_interaction_kernel<8>(float const*)": (4 * 0.5e-3, 4),
                      "void dot_interaction_bwd_kernel(float const*)": (2 * 1e-3, 2)})
    ctx = _ctx(cell, trace=trace)
    assert spec.metric_reader("interaction_dot_fwd_roofline.train")(ctx) == pytest.approx(
        100 * fwd / 0.5e-3)
    assert 100 * fwd / 0.5e-3 == pytest.approx(59.581, rel=1e-4)
    # backward: 4 (2 B F D + B P) = 1,903,951,872 bytes over 1 ms
    assert spec.metric_reader("interaction_dot_bwd_roofline.train")(ctx) == pytest.approx(
        100 * 1_903_951_872 / 3.35e12 / 1e-3)
    assert spec.metric_reader("embedding_ws_grad_ms.train")(ctx) is None
    assert spec.metric_reader("interaction_dot_fwd_roofline.train")(
        _ctx(cell, trace=_summary({}))) is None


def test_idle_share_and_ws_grad():
    cell = spec.load_cell("dlrm-mlperf.train-zipf", BENCH)
    trace = _summary({"void indexing_backward_kernel<float, 4>(...)": (0.02, 4)},
                     units=4, window_s=0.2, busy_s=0.15)
    ctx = _ctx(cell, trace=trace)
    assert spec.metric_reader("device_idle_share.train")(ctx) == pytest.approx(25.0)
    assert spec.metric_reader("embedding_ws_grad_ms.train")(ctx) == pytest.approx(5.0)
    assert spec.metric_reader("device_idle_share.train")(_ctx(cell)) is None


def test_union_and_gaps():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert devtrace.union_us(spans, 0, 50) == 35
    assert devtrace.union_us(spans, 8, 45) == 7 + 10 + 5
    assert devtrace.gaps_us(spans, 0, 50) == [(15, 20), (30, 40)]
    assert devtrace.gaps_us(spans, -5, 60) == [(-5, 0), (15, 20), (30, 40), (50, 60)]


def test_reduce_a_synthetic_trace():
    m = devtrace.MARK
    events = [Event(m, False, 0, 1), Event(m, False, 100, 101), Event(m, False, 200, 201),
              Event(m, False, 300, 301),
              Event("k1", True, 50, 90), Event("k1", True, 110, 150), Event("k2", True, 140, 170),
              Event("k1", True, 250, 280),
              Event("aten::item", False, 170, 240), Event("cudaStreamSynchronize", False, 175, 235)]
    s = devtrace.reduce(events, units=2)
    assert (s.window_s, s.busy_s) == (pytest.approx(200e-6), pytest.approx(90e-6))
    assert s.kernels == {"k1": (pytest.approx(70e-6), 2), "k2": (pytest.approx(30e-6), 1)}
    # gaps (100,110) (170,250) (280,300); the long one inside the synchronize
    assert s.idle_gaps[0] == ("cudaStreamSynchronize", pytest.approx(80e-6))
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(70e-6)] and len(b["idle_gaps"]) <= 10
    with pytest.raises(RuntimeError):
        devtrace.reduce(events, units=3)


def test_p95():
    from portbench.kinds.train import p95

    assert p95(list(range(101))) == 95
    assert math.isclose(p95([1.0, 2.0]), 1.95)
    assert math.isclose(p95([4.0, 1.0, 3.0, 2.0]), 3.85)
    assert p95([7.0]) == 7.0
