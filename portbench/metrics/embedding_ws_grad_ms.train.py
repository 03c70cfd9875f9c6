"""embedding_ws_grad_ms.train (ms): device milliseconds a training step of
the kernels that accumulate the working set's gradient from the batch's
rows (the backward of the gather through the dedup's inverse), by name
from the traced window. Today that is autograd's index backward."""

KERNELS = ["indexing_backward_kernel"]


def read(ctx):
    t = ctx.result.trace
    if t is None:
        return None
    seconds, launches = t.kernel_seconds(KERNELS)
    if not launches:
        return None
    return 1e3 * seconds / t.units
