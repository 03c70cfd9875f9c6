"""Optimizers over dicts of tensors (no external deps).

Production CTR setups use Adam(W) for the dense nets and Adagrad for the
embedding rows; the sparse train step (:func:`repro_torch.models.recsys.
make_sparse_train_step`) runs the row Adagrad itself and takes the dense
optimizer from here. A port of the JAX package's ``train/optimizer.py``
``adamw`` in float32 moments; ``adagrad`` and ``sgd`` are not on the
training path yet.

``update`` works in place: it rewrites the parameter and moment tensors it
is given and returns them, where the JAX version returns new arrays. Its
elementwise steps keep the JAX version's order of operations and its
fused multiply-adds, so on the same gradients the two agree to the last bit
or within an ulp.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Params, Any], Tuple[Params, Any]]


def adamw(lr: float = 1e-4, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0) -> Optimizer:
    """AdamW with bias correction, optional decoupled weight decay and
    global-norm gradient clipping (``clip_norm``; None turns it off).

    State: ``{"m": {name: f32}, "v": {name: f32}, "step": int}``; ``step``
    is a host int, so the bias corrections need no device read.
    """

    def init(params: Params) -> Dict[str, Any]:
        return {"m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(params: Params, grads: Params, state: Dict[str, Any]
               ) -> Tuple[Params, Dict[str, Any]]:
        step = state["step"] + 1
        names = sorted(params)  # the JAX tree order of a dict's leaves
        ps = [params[k] for k in names]
        gs = [grads[k].to(torch.float32) for k in names]
        ms = [state["m"][k] for k in names]
        vs = [state["v"][k] for k in names]
        if clip_norm is not None:
            sq = torch.zeros((), dtype=torch.float32, device=gs[0].device)
            for g in gs:
                sq = sq + torch.sum(g * g)
            scale = torch.clamp(clip_norm / torch.clamp(torch.sqrt(sq), min=1e-9), max=1.0)
            gs = torch._foreach_mul(gs, scale)
        # m = b1*m + (1-b1)*g and v = b2*v + (1-b2)*g*g, each as one fused
        # multiply-add of the decayed moment, as XLA contracts them
        dev = gs[0].device
        b1_t = torch.full((), b1, dtype=torch.float32, device=dev)
        b2_t = torch.full((), b2, dtype=torch.float32, device=dev)
        torch._foreach_copy_(ms, torch._foreach_addcmul(
            torch._foreach_mul(gs, 1 - b1), ms, [b1_t] * len(ms)))
        torch._foreach_copy_(vs, torch._foreach_addcmul(
            torch._foreach_mul(torch._foreach_mul(gs, 1 - b2), gs), vs, [b2_t] * len(vs)))
        # bias corrections in float32, as the JAX version computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        delta = torch._foreach_div(ms, bc1)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_mul_(delta, lr)
        torch._foreach_div_(delta, denom)
        if weight_decay:
            torch._foreach_add_(delta, torch._foreach_mul(ps, lr * weight_decay))
        torch._foreach_sub_(ps, delta)
        return dict(zip(names, ps)), {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init=init, update=update)
