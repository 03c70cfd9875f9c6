"""Rehearses the first-step bounds of ``chip_smoke.py`` phases 13 and 14 on
the CPU: one sparse step of each in-memory arch and of BST at the phases'
shapes (8,192 rows of ``synthetic_batch`` at published widths,
``dlrm-mlperf`` capped as the phase caps it), in fp32 against fp64, the table replaced by random rows of
the working set (the batch's ids need no table). Prints, per arch, what
the phase prints against its ``FIRST_*`` bounds: the loss, the dense
gradients, the index backward alone (fp32, against the float64 sum of
its occurrences' gradients) and the working-row gradients (fp32 against
fp64), with the counts of rows over several fractions of max(S_rj, G).

  PYTHONPATH=src python tests/rehearse_first_step.py [rows]

Imports nothing of JAX. Ends with the heaviest row's gradient made wrong
(one occurrence left out), read by both checks.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as S  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.embedding.dedup import dedup  # noqa: E402
from repro_torch.kernels.interaction_dot import ops as iops  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402

CPU = torch.device("cpu")


def _bce64(logits, labels):
    logits, labels = logits.to(torch.float64), labels.to(torch.float64)
    return torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _dots64(x):
    f = x.shape[1]
    rows, cols = torch.tril_indices(f, f, -1)
    return torch.einsum("bfd,bgd->bfg", x, x)[:, rows, cols]


def _layer_norm64(x, w, b, *, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rehearse(arch: str, rows: int) -> None:
    cfg = get_arch(arch).config
    if arch == "dlrm-mlperf":
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, S.VOCAB_CAP)
                                                         for v in cfg.vocab_sizes))
    batch = synthetic_batch("recsys", cfg, rows, 0, device=CPU)
    shapes, gids = S.site_shapes(torch, cfg, batch)
    unique, inverse, n = dedup(gids, capacity=cfg.dedup_capacity or gids.numel())
    n = int(n)
    bound = 1 / np.sqrt(cfg.embed_dim)
    working = torch.empty((unique.shape[0], cfg.embed_dim)).uniform_(
        -bound, bound, generator=torch.Generator().manual_seed(1))
    dense = R.init_params(cfg, torch.Generator().manual_seed(0), include_embed=False)
    ws32 = R.working_set_grads(dense, cfg, batch, working, unique, torch.tensor(n), inverse,
                               shapes)
    occ32 = S.occurrence_grads(torch, dense, cfg, batch, working, inverse)
    c64 = dataclasses.replace(cfg, dtype=torch.float64)
    d64 = {k: v.double() for k, v in dense.items()}
    b64 = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
    with mock.patch.object(R, "sigmoid_bce", _bce64), \
            mock.patch.object(iops, "pairwise_dots", _dots64), \
            mock.patch.object(R, "layer_norm", _layer_norm64):
        ws64 = R.working_set_grads(d64, c64, b64, working.double(), unique, torch.tensor(n),
                                   inverse, shapes)
        occ64 = S.occurrence_grads(torch, d64, c64, b64, working.double(), inverse)
    loss32, loss64 = float(ws32.loss), float(ws64.loss)
    dense_rel = {k: float((ws32.dense_grads[k].double() - g).abs().max() / g.abs().max())
                 for k, g in ws64.dense_grads.items() if float(g.abs().max()) > 0}
    k_worst = max(dense_rel, key=dense_rel.get)
    idx_ratio, idx_bound = S.index_backward_ratios(torch, ws32.working_grad, occ32, inverse, n)
    ratio, scale, big_g, counts = S.row_grad_ratios(torch, ws32.working_grad, ws64.working_grad,
                                                    occ64, inverse, n)
    per_row = ratio.amax(dim=1)
    want = ws64.working_grad[:n]
    heavy = counts[:, 0] >= 64
    jmax = want.abs().argmax(dim=1, keepdim=True)
    top = want.abs().gather(1, jmax)[heavy]
    print(f"== {arch} rows={rows} working rows={n:,} occurrences up to {int(counts.max()):,} "
          f"G={big_g:.3e}")
    print(f"  loss fp32 {loss32:.9f} fp64 {loss64:.9f} rel {abs(loss32 - loss64) / loss64:.2e}; "
          f"dense grads largest |f32 - f64| / max|g| {dense_rel[k_worst]:.3e} ({k_worst})")
    print(f"  index backward: largest |f32 - sum of occurrences| / ((c_r + 1) 2^-24 S'_rj) "
          f"{float(idx_ratio.max()):.3e}")
    print(f"  row grads: largest |f32 - f64| / max(S_rj, G) {float(per_row.max()):.3e} at a row "
          f"of {int(counts[int(per_row.argmax())])} occurrences; rows over "
          + ", ".join(f"{t:g}: {int((per_row > t).sum())}" for t in (1e-3, 2e-3, 5e-3, 1e-2)))
    if heavy.any():
        idx_share = float((idx_bound.gather(1, jmax)[heavy] / top).max())
        row_share = float((S.FIRST_ROW_TOL * scale.gather(1, jmax)[heavy] / top).max())
        print(f"  rows of 64 or more occurrences: {int(heavy.sum()):,}; at each one's largest |g| "
              f"the index bound is at most {idx_share:.3e} of it and the row bound at most "
              f"{row_share:.3e}")
    print("  heaviest rows: " + S.heavy_rows(torch, want.double(), counts,
                                             {"index_bound": idx_bound,
                                              "row_bound": S.FIRST_ROW_TOL * scale}))
    # a wrong index backward: the heaviest row without one of its occurrences
    r = int(counts[:, 0].argmax())
    dropped = ws32.working_grad.clone()
    dropped[r] -= occ32[int((inverse.reshape(-1) == r).nonzero()[0])]
    idx_read = S.index_backward_ratios(torch, dropped, occ32, inverse, n)[0][r].max()
    row_read = S.row_grad_ratios(torch, dropped, ws64.working_grad, occ64, inverse, n)[0][r].max()
    print(f"  the heaviest row ({int(counts[r, 0]):,} occurrences) without one of them: "
          f"{float(idx_read):.3e} of the index bound; the card-vs-cpu check reads "
          f"{float(row_read):.3e} (bound {S.FIRST_ROW_TOL})")


if __name__ == "__main__":
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else S.TRAIN_ROWS
    for arch in S.INMEM_ARCHS + ("bst",):          # phases 13 and 14
        rehearse(arch, rows)
