"""interaction_dot_fwd_roofline.score (%): the least time of one forward
pairwise-dot launch at the scoring batch over its mean device time in the
traced window. The work is that of the shapes, whatever computes it:
B = the mix's rows, F = n_sparse + 1 fields (the bottom output among them),
D = embed_dim, P = F (F - 1) / 2 pairs; reading the fields once and writing
the dots once is 4 (B F D + B P) bytes, and 2 B P D FLOPs."""

from portbench.peaks import least_seconds

KERNELS = ["dot_interaction_kernel"]


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
    return 100.0 * least_seconds(4 * (b * f * d + b * p), 2 * b * p * d) / (seconds / launches)
