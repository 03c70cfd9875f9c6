"""serve_lookup_ms.score (ms): device milliseconds a batch of the program's
``embed.lookup`` span: the lookup of a scoring batch's rows (dedup, gather,
expand). The median over the traced batches, timed by the span's CUDA
events on its stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("embed.lookup")
