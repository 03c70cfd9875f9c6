"""ws_grad_roofline.train (%): the least time of the working set's
gradient (the backward of the gather through the dedup's inverse) over the
device seconds a training step of the kernels that compute it, those whose
name holds ``ws_grad_``, in the traced window. With N = rows x n_sparse
gathered rows of D = embed_dim and cap = the configuration's dedup
capacity (N where it is 0 or unset): reading each gradient row once, a
slot key and a sorted position for each, and writing each of the cap
output rows once is 4 (N D + cap D + 2 N) bytes, with no FLOPs counted."""

from portbench.peaks import least_seconds

KERNELS = ["ws_grad_"]


def read(ctx):
    t = ctx.result.trace
    if t is None:
        return None
    seconds, launches = t.kernel_seconds(KERNELS)
    if not launches:
        return None
    cfg = ctx.cell.config
    d = cfg["embed_dim"]
    n = ctx.cell.mix["rows"] * cfg["n_sparse"]
    cap = cfg.get("dedup_capacity") or n
    return 100.0 * least_seconds(4 * (n * d + cap * d + 2 * n), 0) / (seconds / t.units)
