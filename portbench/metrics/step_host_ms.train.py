"""step_host_ms.train (ms): host milliseconds a step of the program's
``train.step`` span: the host's time to enqueue a training step
(``run_training``'s span around the step, which returns before the card has
run it). The median over the traced steps; how far it stays under the
step's device time is the host's headroom before it sets the pace."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms("train.step")
