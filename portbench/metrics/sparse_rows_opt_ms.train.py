"""sparse_rows_opt_ms.train (ms): device milliseconds a step of the program's
``sparse.rows_opt`` span: row Adagrad over the working set and both
scatters back into the table and the accumulators. The median over the
traced steps, timed by the span's CUDA events on its stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("sparse.rows_opt")
