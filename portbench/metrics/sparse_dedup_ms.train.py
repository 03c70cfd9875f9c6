"""sparse_dedup_ms.train (ms): device milliseconds a step of the program's
``sparse.dedup`` span: the batch's packed ids collected, concatenated and
deduplicated into the working set (``collect_gids``, ``cat``, ``dedup``).
The median over the traced steps, timed by the span's CUDA events on its
stream."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms("sparse.dedup")
