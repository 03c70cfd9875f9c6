"""sparse_dense_opt_ms.train (ms): device milliseconds a step of the program's
``sparse.dense_opt`` span: the dense optimizer's update (AdamW). The median
over the traced steps, timed by the span's CUDA events on its stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("sparse.dense_opt")
