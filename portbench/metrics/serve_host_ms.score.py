"""serve_host_ms.score (ms): host milliseconds a batch of the program's
``serve.step`` span: the host's time in ``serve_step``, the whole scoring
call up to the enqueue of its last kernel. The median over the traced
batches; how far it stays under the batch's device time is the host's
headroom before it sets the pace."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms("serve.step")
