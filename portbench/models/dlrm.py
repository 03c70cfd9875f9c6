"""DLRM [arXiv:1906.00091] in plain PyTorch, fp32: the bottom MLP over the
dense features (ReLU after every layer), the pairwise dots of the bottom
output and the sparse fields' rows (the strictly lower triangle, row-major),
the bottom output and those dots into the top MLP (ReLU between layers, none
after the last), one logit a row. Weights are ``(in, out)``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.weights import table_rows


def _mlp_shapes(prefix: str, d_in: int, dims) -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for i, d in enumerate(dims):
        shapes[f"{prefix}_w{i}"] = (d_in, d)
        shapes[f"{prefix}_b{i}"] = (d,)
        d_in = d
    return shapes


def _n_pairs(cfg) -> int:
    f = cfg["n_sparse"] + 1
    return f * (f - 1) // 2


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    shapes = {"embed": (table_rows(cfg), cfg["embed_dim"])}
    shapes.update(_mlp_shapes("bot", cfg["n_dense"], cfg["bot_mlp"]))
    shapes.update(_mlp_shapes("top", _n_pairs(cfg) + cfg["bot_mlp"][-1], cfg["top_mlp"]))
    return shapes


def _mlp(x, params, prefix, n, relu_last):
    for i in range(n):
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if i < n - 1 or relu_last:
            x = torch.relu(x)
    return x


def forward(params, cfg, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Logits f32[B] from dense f32[B, n_dense] and the rows f32[B, F, D]."""
    bot = _mlp(dense, params, "bot", len(cfg["bot_mlp"]), relu_last=True)
    fields = torch.cat([bot[:, None, :], emb], dim=1)
    f = fields.shape[1]
    rows, cols = torch.tril_indices(f, f, -1, device=fields.device)
    dots = torch.bmm(fields, fields.transpose(1, 2))[:, rows, cols]
    return _mlp(torch.cat([bot, dots], dim=1), params, "top", len(cfg["top_mlp"]),
                relu_last=False)[:, 0]


def forward_flops_per_row(cfg) -> int:
    """Model FLOPs of one row's forward: 2 per multiply-add of every MLP
    layer and of the pairwise dots (only the lower triangle's pairs)."""
    macs = sum(s[0] * s[1] for k, s in param_shapes(cfg).items()
               if k != "embed" and len(s) == 2)
    return 2 * (macs + _n_pairs(cfg) * cfg["embed_dim"])
