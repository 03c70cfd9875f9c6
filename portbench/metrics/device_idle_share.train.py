"""device_idle_share.train (%): the share of the traced window of training
steps in which no kernel, copy or memset ran on the card."""


def read(ctx):
    t = ctx.result.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
