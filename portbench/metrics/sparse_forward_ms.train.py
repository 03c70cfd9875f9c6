"""sparse_forward_ms.train (ms): device milliseconds a step of the program's
``sparse.forward`` span: the batch's rows taken from the working set at
each site, the forward and the loss. The median over the traced steps,
timed by the span's CUDA events on its stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("sparse.forward")
