"""Common model layers. Dense weights keep the JAX ``(in, out)`` layout so
parameters carry across from the JAX package name for name."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with the JAX package's formula: an fp32
    mean of squares, ``rsqrt(var + eps)``, then the weight, cast back."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: ``(silu(x @ w1) * (x @ w3)) @ w2``."""
    h = torch.nn.functional.silu(dense(x, w1)) * dense(x, w3)
    return dense(h, w2)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy from integer labels, ``logsumexp - gold``;
    logits ``f[*, V]``, labels ``int[*]``. The logsumexp shifts by the row's
    max (held constant under grad), as ``jax.scipy.special.logsumexp``."""
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return lse - gold


# ------------------------------------------------------------------- inits
def fold_in(seed: int, index: int) -> int:
    """A 64-bit seed for param ``index`` of a run seeded with ``seed`` (the
    port's counterpart of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0])


# The JAX package's distributions, drawn from an explicit generator; the
# bits are not JAX's PRNG's (tests carry JAX's params over instead).
def he_init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 1 else 1
    return (torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
            * float(np.sqrt(2.0 / max(fan_in, 1))))


def glorot_init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=dtype, device=generator.device).uniform_(
        -lim, lim, generator=generator)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device) * 0.02
