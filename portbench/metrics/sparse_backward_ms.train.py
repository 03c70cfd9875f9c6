"""sparse_backward_ms.train (ms): device milliseconds a step of the program's
``sparse.backward`` span: ``torch.autograd.grad`` of the loss with respect
to the dense params and the working rows, whatever kernels compute it. The
median over the traced steps, timed by the span's CUDA events on its
stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("sparse.backward")
