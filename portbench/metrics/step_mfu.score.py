"""step_mfu.score (%): the model FLOPs of the window's scoring batches over
the window's seconds, as a share of the card's peak in the configuration's
precision. A batch's model FLOPs are the forward's, counted from the
configuration's shapes by the model module."""

from portbench.peaks import peak_flops


def read(ctx):
    w = ctx.result.window
    if not w["units"]:
        return None
    cfg = ctx.cell.config
    flops = ctx.cell.model.forward_flops_per_row(cfg) * w["rows"] * w["units"]
    return 100.0 * flops / w["seconds"] / peak_flops(cfg)
