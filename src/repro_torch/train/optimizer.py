"""Optimizers over dicts of tensors (no external deps).

Production CTR setups use Adam(W) for the dense nets and Adagrad for the
embedding rows; the sparse train step (:func:`repro_torch.models.recsys.
make_sparse_train_step`) runs the row Adagrad itself and takes the dense
optimizer from here; the LM train step (:func:`repro_torch.models.
transformer.make_train_step`) takes AdamW too. A port of the JAX package's
``train/optimizer.py``: ``adamw`` (float32 moments and math by default, or
reduced-precision ones: the 236B MoE keeps its moments in bfloat16 to fit),
``adagrad`` and ``sgd`` (with or without momentum). Each optimizer's
``abstract_state(params)`` gives its state as ``meta`` tensors, for the dry
run (:mod:`repro_torch.configs.base`).

A param tree is a dict of tensors, or of such dicts (the LM's stacked
``dense_layers``); its leaves are taken in the JAX tree order, the sorted
dotted names (``dense_layers.attn_wq``), and the state is keyed by them.
``update`` works in place: it rewrites the parameter and state tensors it is
given and returns them, where the JAX version returns new arrays. Its
elementwise steps keep the JAX version's order of operations and its fused
multiply-adds, so on the same gradients the two agree to the last bit or
within an ulp. The elementwise work runs over groups of leaves of at most
``GROUP_ELEMS`` elements, so its temporaries stay bounded for a model of
billions of parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

Params = Dict[str, Any]
GROUP_ELEMS = 1 << 28          # leaves per group of the elementwise steps (1 GiB of fp32)


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Params, Any], Tuple[Params, Any]]
    abstract_state: Callable[[Params], Any]


def _meta_like(flat: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(p.shape, dtype=dtype, device="meta") for k, p in flat.items()}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{dotted name: leaf}`` of a dict of tensors or of such dicts."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Mapping[str, torch.Tensor]) -> Params:
    """Inverse of :func:`flatten`."""
    out: Params = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _groups(names: List[str], flat: Mapping[str, torch.Tensor]) -> Iterator[List[str]]:
    group: List[str] = []
    n = 0
    for k in names:
        if group and n + flat[k].numel() > GROUP_ELEMS:
            yield group
            group, n = [], 0
        group.append(k)
        n += flat[k].numel()
    if group:
        yield group


def _bias_corrections(step, b1: float, b2: float):
    """``(1 - b1**step, 1 - b2**step)`` in float32: host floats for a host
    int ``step``, 0-d tensors on the step's device for a tensor ``step``
    (the dry run's abstract state, materialised or on ``meta``)."""
    if isinstance(step, torch.Tensor):
        sf = step.to(torch.float32)
        return tuple(1 - torch.full((), b, dtype=torch.float32, device=step.device).pow(sf)
                     for b in (b1, b2))
    return tuple(float(np.float32(1) - np.float32(b) ** np.float32(step)) for b in (b1, b2))


def adamw(lr: float = 1e-4, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype: torch.dtype = torch.float32,
          compute_dtype: torch.dtype = torch.float32,
          clip_norm: float | None = 1.0) -> Optimizer:
    """AdamW with bias correction, optional decoupled weight decay and
    global-norm gradient clipping (``clip_norm``; None turns it off).

    State: ``{"m": {name: moment_dtype}, "v": {name: moment_dtype},
    "step": int}``; ``step`` is a host int from ``init``, so the bias
    corrections need no device read, and an int32 0-d tensor from
    ``abstract_state`` (JAX's), which ``update`` takes too. With
    ``compute_dtype`` below float32 the gradients, moments and update are
    computed in it (the bias-corrected scalars in float32, then cast), each
    operation rounded to it as the JAX version's is.
    """
    cd, md = compute_dtype, moment_dtype

    def init(params: Params) -> Dict[str, Any]:
        flat = flatten(params)
        return {"m": {k: torch.zeros_like(p, dtype=md) for k, p in flat.items()},
                "v": {k: torch.zeros_like(p, dtype=md) for k, p in flat.items()},
                "step": 0}

    def abstract_state(params: Params) -> Dict[str, Any]:
        flat = flatten(params)
        return {"m": _meta_like(flat, md), "v": _meta_like(flat, md),
                "step": torch.empty((), dtype=torch.int32, device="meta")}

    def clip_scale(names, gflat, dev):
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for k in names:
            g = gflat[k].to(torch.float32)
            sq = sq + torch.sum(g * g)
        return torch.clamp(clip_norm / torch.clamp(torch.sqrt(sq), min=1e-9), max=1.0)

    @torch.no_grad()
    def update(params: Params, grads: Params, state: Dict[str, Any]
               ) -> Tuple[Params, Dict[str, Any]]:
        step = state["step"] + 1
        flat, gflat = flatten(params), flatten(grads)
        names = sorted(flat)  # the JAX tree order of a dict's leaves
        bc1, bc2 = _bias_corrections(step, b1, b2)
        if cd != torch.float32 or md != torch.float32:
            _update_reduced(flat, gflat, state, names, bc1, bc2)
        else:
            _update_f32(flat, gflat, state, names, bc1, bc2)
        return unflatten({k: flat[k] for k in names}), {"m": state["m"], "v": state["v"],
                                                        "step": step}

    def _update_f32(flat, gflat, state, names, bc1, bc2):
        dev = flat[names[0]].device
        scale = clip_scale(names, gflat, dev) if clip_norm is not None else None
        b1_t = torch.full((), b1, dtype=torch.float32, device=dev)
        b2_t = torch.full((), b2, dtype=torch.float32, device=dev)
        for group in _groups(names, flat):
            ps = [flat[k] for k in group]
            gs = [gflat[k].to(torch.float32) for k in group]
            ms = [state["m"][k] for k in group]
            vs = [state["v"][k] for k in group]
            if scale is not None:
                gs = torch._foreach_mul(gs, scale)
            # m = b1*m + (1-b1)*g and v = b2*v + (1-b2)*g*g, each as one fused
            # multiply-add of the decayed moment, as XLA contracts them
            torch._foreach_copy_(ms, torch._foreach_addcmul(
                torch._foreach_mul(gs, 1 - b1), ms, [b1_t] * len(ms)))
            torch._foreach_copy_(vs, torch._foreach_addcmul(
                torch._foreach_mul(torch._foreach_mul(gs, 1 - b2), gs), vs, [b2_t] * len(vs)))
            del gs
            delta = torch._foreach_div(ms, bc1)
            denom = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_mul_(delta, lr)
            torch._foreach_div_(delta, denom)
            del denom
            ps32 = [p.to(torch.float32) for p in ps]      # a bf16 param: rounded once
            if weight_decay:
                torch._foreach_add_(delta, torch._foreach_mul(ps32, lr * weight_decay))
            torch._foreach_copy_(ps, torch._foreach_sub(ps32, delta))

    def _update_reduced(flat, gflat, state, names, bc1, bc2):
        # every constant and operand in `cd`, each operation rounded to it
        dev = flat[names[0]].device
        c = {name: torch.full((), val, dtype=cd, device=dev) for name, val in
             (("b1", b1), ("1-b1", 1 - b1), ("b2", b2), ("1-b2", 1 - b2), ("lr", lr),
              ("eps", eps), ("wd", lr * weight_decay))}
        bc1, bc2 = (torch.as_tensor(bc, dtype=torch.float32, device=dev).to(cd)
                    for bc in (bc1, bc2))
        gcd = {k: gflat[k].to(cd) for k in names}
        scale = clip_scale(names, gcd, dev).to(cd) if clip_norm is not None else None
        for k in names:
            p, m, v = flat[k], state["m"][k], state["v"][k]
            g = gcd.pop(k)
            if scale is not None:
                g = g * scale
            m.copy_((c["b1"] * m.to(cd) + c["1-b1"] * g).to(md))
            v.copy_((c["b2"] * v.to(cd) + c["1-b2"] * g * g).to(md))
            del g
            delta = c["lr"] * (m.to(cd) / bc1) / (torch.sqrt(v.to(cd) / bc2) + c["eps"])
            if weight_decay:
                delta = delta + c["wd"] * p.to(cd)
            p.copy_((p.to(cd) - delta).to(p.dtype))

    return Optimizer(init=init, update=update, abstract_state=abstract_state)


def adagrad(lr: float = 0.01, *, eps: float = 1e-10) -> Optimizer:
    """Adagrad over the whole tree: ``accum += g*g`` (float32), then
    ``p - lr*g / (sqrt(accum) + eps)``. State: ``{"accum": {name: f32}}``."""

    def init(params: Params) -> Dict[str, Any]:
        return {"accum": {k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in flatten(params).items()}}

    def abstract_state(params: Params) -> Dict[str, Any]:
        return {"accum": _meta_like(flatten(params), torch.float32)}

    @torch.no_grad()
    def update(params: Params, grads: Params, state: Dict[str, Any]
               ) -> Tuple[Params, Dict[str, Any]]:
        flat, gflat = flatten(params), flatten(grads)
        names = sorted(flat)
        for group in _groups(names, flat):
            ps = [flat[k] for k in group]
            gs = [gflat[k].to(torch.float32) for k in group]
            accs = [state["accum"][k] for k in group]
            torch._foreach_addcmul_(accs, gs, gs)             # a + g*g, one FMA as XLA's
            denom = torch._foreach_sqrt(accs)
            torch._foreach_add_(denom, eps)
            delta = torch._foreach_mul(gs, lr)
            torch._foreach_div_(delta, denom)
            torch._foreach_copy_(ps, torch._foreach_sub([p.to(torch.float32) for p in ps], delta))
        return unflatten({k: flat[k] for k in names}), state

    return Optimizer(init=init, update=update, abstract_state=abstract_state)


def sgd(lr: float = 0.01, *, momentum: float = 0.0) -> Optimizer:
    """SGD, ``p - lr*g``; with ``momentum`` the heavy-ball form ``mu =
    momentum*mu + g``, ``p - lr*mu``. State: ``{"mu": {name: f32}}`` with
    momentum, else ``{}``."""

    def init(params: Params) -> Dict[str, Any]:
        if momentum:
            return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                           for k, p in flatten(params).items()}}
        return {}

    def abstract_state(params: Params) -> Dict[str, Any]:
        return {"mu": _meta_like(flatten(params), torch.float32)} if momentum else {}

    @torch.no_grad()
    def update(params: Params, grads: Params, state: Dict[str, Any]
               ) -> Tuple[Params, Dict[str, Any]]:
        flat, gflat = flatten(params), flatten(grads)
        names = sorted(flat)
        dev = flat[names[0]].device
        mom_t = torch.full((), momentum, dtype=torch.float32, device=dev)
        neg_lr = torch.full((), -lr, dtype=torch.float32, device=dev)
        for group in _groups(names, flat):
            ps = [flat[k] for k in group]
            gs = [gflat[k].to(torch.float32) for k in group]
            if momentum:
                mus = [state["mu"][k] for k in group]
                # momentum*mu + g, one FMA as XLA contracts it
                torch._foreach_copy_(mus, torch._foreach_addcmul(gs, mus, [mom_t] * len(mus)))
                gs = mus
            # p - lr*g, one FMA as XLA contracts it
            torch._foreach_copy_(ps, torch._foreach_addcmul([p.to(torch.float32) for p in ps],
                                                            gs, [neg_lr] * len(gs)))
        return unflatten({k: flat[k] for k in names}), state

    return Optimizer(init=init, update=update, abstract_state=abstract_state)
