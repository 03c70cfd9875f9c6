"""interaction_dot_bwd_roofline.train (%): the least time of one backward
pairwise-dot launch at the training batch over its mean device time in the
traced window. With B = the mix's rows, F = n_sparse + 1 fields, D =
embed_dim and P = F (F - 1) / 2 pairs: reading the fields and the dots'
gradient once and writing the fields' gradient once is 4 (2 B F D + B P)
bytes, and each pair's gradient reaches both its fields, 4 B P D FLOPs."""

from portbench.peaks import least_seconds

KERNELS = ["dot_interaction_bwd_kernel"]


def read(ctx):
    t = ctx.result.trace
    if t is None:
        return None
    seconds, launches = t.kernel_seconds(KERNELS)
    if not launches:
        return None
    cfg = ctx.cell.config
    b, f, d = ctx.cell.mix["rows"], cfg["n_sparse"] + 1, cfg["embed_dim"]
    p = f * (f - 1) // 2
    return 100.0 * least_seconds(4 * (2 * b * f * d + b * p), 4 * b * p * d) / (seconds / launches)
