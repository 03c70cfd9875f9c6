"""sparse_gather_ms.train (ms): device milliseconds a step of the program's
``sparse.gather`` span: the working set's rows gathered from the table (the
FILL ``where`` and ``take_rows``). The median over the traced steps, timed
by the span's CUDA events on its stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("sparse.gather")
