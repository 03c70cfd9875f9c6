"""step_mfu.train (%): the model FLOPs of the window's training steps over
the window's seconds, as a share of the card's peak in the configuration's
precision. A step's model FLOPs are three times the forward's (forward,
and the backward's two products of every layer), counted from the
configuration's shapes by the model module."""

from portbench.peaks import peak_flops

PASSES = 3


def read(ctx):
    w = ctx.result.window
    if not w["units"]:
        return None
    cfg = ctx.cell.config
    flops = PASSES * ctx.cell.model.forward_flops_per_row(cfg) * w["rows"] * w["units"]
    return 100.0 * flops / w["seconds"] / peak_flops(cfg)
