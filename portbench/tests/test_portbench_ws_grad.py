"""The arithmetic of ``ws_grad_roofline.train`` against numbers worked by
hand: the byte count of the working set's gradient at the train cell's
shape, the share over the ``ws_grad_`` kernels' device time, and no reading
where those kernels are absent."""

import types

import pytest
from conftest import BENCH

from portbench import devtrace, spec


def _ctx(cell, trace=None):
    return types.SimpleNamespace(cell=cell, result=types.SimpleNamespace(window=None,
                                                                         trace=trace))


def _summary(kernels, units=4):
    return devtrace.TraceSummary(units=units, window_s=1.0, busy_s=0.5, kernels=kernels,
                                 idle_gaps=[])


def test_ws_grad_roofline_by_hand():
    cell = spec.load_cell("dlrm-mlperf.train-zipf", BENCH)
    # N = cap = 65,536 x 26 = 1,703,936 rows of D = 128: 4 (N D + cap D + 2 N)
    # = 1,758,461,952 bytes, 0.5249 ms at 3.35 TB/s; 4 units of 1 ms each
    least = 1_758_461_952 / 3.35e12
    assert least == pytest.approx(0.5249e-3, rel=1e-4)
    trace = _summary({"void (anonymous namespace)::ws_grad_chunk_kernel<true>(...)": (3e-3, 4),
                      "void (anonymous namespace)::ws_grad_finish_kernel<true>(...)": (1e-3, 4),
                      "void indexing_backward_kernel<float, 4>(...)": (9.0, 4)})
    reader = spec.metric_reader("ws_grad_roofline.train")
    assert reader(_ctx(cell, trace=trace)) == pytest.approx(100 * least / 1e-3)
    assert reader(_ctx(cell, trace=_summary({"void indexing_backward_kernel<float, 4>(...)":
                                                 (0.02, 4)}))) is None
    assert reader(_ctx(cell)) is None
