"""Common model layers. Dense weights keep the JAX ``(in, out)`` layout so
parameters carry across from the JAX package name for name."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the JAX package's formula: an fp32
    mean, the centred variance, ``rsqrt(var + eps)``, then weight and bias."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def mlp(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], *,
        act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        final_act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Plain MLP over lists of weights/biases (recsys towers)."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = dense(x, w, b)
        if i < len(ws) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy from logits (CTR loss):
    ``max(l, 0) - l*y + log1p(exp(-|l|))``."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
