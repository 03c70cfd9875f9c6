"""Mixture-of-Experts FFN (DeepSeek-style: shared + fine-grained routed).

A port of the JAX package's ``models/moe.py`` for one device (its
``mesh=None`` path). Dispatch is sort-based with a per-expert capacity
(GShard-style dropping, no one-hot einsum over tokens): each token's top-k
``(token, k)`` pairs are sorted by expert (a stable sort), a pair's slot
within its expert comes from the sorted order, and pairs past the
capacity ``ceil(T * k / E * capacity_factor)`` of the call are dropped into
a spare slot that is thrown away. The experts' SwiGLU runs as batched
products over ``(E, C, d)``.

The combine is deterministic: each token's k weighted expert outputs are
gathered in ascending sorted position and added one after another from
zero, the order of the JAX package's ``segment_sum`` on the CPU; a scatter
with atomics on the card would not repeat from run to run.

Expert parallelism (``mesh=``, the JAX ``shard_map`` branch): experts over
the ``model`` axis, tokens (rows) over ``dp_axes`` and replicated over
``model``. Each rank routes its data shard's tokens, builds ONLY its local
experts' dispatch buffer (:func:`_experts_local`, the rank body), runs
their FFN, combines into a partial output and the partials are summed over
``model`` (:func:`repro_torch.launch.mesh.psum`). With
``shard_ff_over_data`` the expert hidden dim is also split over ``data``
and all-gathered at use (ZeRO-3). As in JAX, the capacity follows the
*shard's* token count, so the sharded MoE computes each data shard's MoE
(ROADMAP C30), and the aux loss has the value of data shard 0 and the
gradient of the mean of the shards' auxes (C31).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sharding import P
from repro_torch.launch import mesh as M
from repro_torch.models.common import dense


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    # sharding (the JAX mesh path): expert hidden dim over the data axis
    shard_ff_over_data: bool = False


def moe_params_shape(d_model: int, c: MoEConfig) -> Dict[str, Tuple[int, ...]]:
    e, f = c.n_experts, c.d_ff_expert
    shapes = {
        "router": (d_model, e),
        "w1": (e, d_model, f),
        "w3": (e, d_model, f),
        "w2": (e, f, d_model),
    }
    if c.n_shared:
        fs = c.n_shared * f
        shapes.update({
            "sw1": (d_model, fs),
            "sw3": (d_model, fs),
            "sw2": (fs, d_model),
        })
    return shapes


def param_specs(c: MoEConfig, *, tp: str = "model") -> Dict[str, P]:
    """The shards ``moe_ffn(mesh=)`` takes: experts over ``tp`` (their
    hidden dim over ``data`` too with ``shard_ff_over_data``), the router
    replicated, the shared experts column- (``sw1``, ``sw3``) and
    row-parallel (``sw2``) over ``tp``: the LM's ``moe_*`` specs once the
    layer's FSDP gather has taken ``data`` off the shared experts."""
    ff = "data" if c.shard_ff_over_data else None
    specs = {"router": P(None, None), "w1": P(tp, None, ff), "w3": P(tp, None, ff),
             "w2": P(tp, ff, None)}
    if c.n_shared:
        specs.update({"sw1": P(None, tp), "sw3": P(None, tp), "sw2": P(tp, None)})
    return specs


def capacity(n_tokens: int, c: MoEConfig) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens (at least 1)."""
    return max(int(math.ceil(n_tokens * c.top_k / c.n_experts * c.capacity_factor)), 1)


def _route(x: torch.Tensor, router: torch.Tensor, c: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax routing in fp32 + top-k with renormalized combine weights;
    returns (top_e int32 (T, K), top_p (T, K), the load-balance aux)."""
    logits = torch.matmul(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    top_p, top_e = torch.topk(probs, c.top_k, dim=-1)            # (T, K), descending
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # load-balance aux (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    fe = F.one_hot(top_e[:, 0], c.n_experts).to(torch.float32).mean(dim=0)
    aux = c.n_experts * torch.sum(fe * me)
    return top_e.to(torch.int32), top_p, aux


def _dispatch_indices(top_e: torch.Tensor, c: MoEConfig, capacity: int):
    """Sort-based dispatch plan: for each sorted ``(token, k)`` pair its
    flat index (``order``), expert, slot in the expert (``pos``), whether it
    fits (``keep``) and its token; all int32 but ``keep``."""
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)                                   # (T*K,)
    order = torch.sort(flat_e, stable=True).indices              # sort by expert
    sorted_e = flat_e[order]
    se = sorted_e.to(torch.int64)
    counts = torch.zeros(c.n_experts, dtype=torch.int64, device=top_e.device).index_add_(
        0, se, torch.ones_like(se))                              # static shape (no bincount)
    starts = torch.cumsum(counts, 0) - counts                    # expert offsets
    pos = torch.arange(t * k, dtype=torch.int32, device=top_e.device) - starts[se].to(torch.int32)
    keep = pos < capacity
    token = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    return order.to(torch.int32), sorted_e, pos, keep, token


def _expert_ffn(xe: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over (E, C, d) with weights (E, d, f) / (E, f, d)."""
    h = F.silu(torch.bmm(xe, w1.to(xe.dtype))) * torch.bmm(xe, w3.to(xe.dtype))
    return torch.bmm(h, w2.to(xe.dtype))


def _combine(contrib: torch.Tensor, order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """``out[token] = sum`` of the token's k rows of ``contrib`` (in sorted
    order), added one after another from zero in ascending sorted position."""
    inv = torch.empty_like(order, dtype=torch.int64)
    inv[order.to(torch.int64)] = torch.arange(t * k, device=order.device)
    rows = torch.sort(inv.reshape(t, k), dim=1).values           # (T, K) sorted positions
    per = contrib[rows]                                          # (T, K, d)
    out = torch.zeros_like(per[:, 0])
    for i in range(k):
        out = out + per[:, i]
    return out


def _experts_local(x: torch.Tensor, top_e: torch.Tensor, top_p: torch.Tensor,
                   w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, c: MoEConfig, *,
                   n_local: int, local_offset: int = 0) -> torch.Tensor:
    """The rank body: tokens (T, d) routed to ``top_e`` with weights
    ``top_p`` -> the output of the experts ``[local_offset * n_local,
    (local_offset + 1) * n_local)`` (whose weights ``w1``, ``w3``, ``w2``
    are), zero for the other pairs; summed over the ranks it is the MoE's."""
    t, d = x.shape
    cap = capacity(t, c)
    order, sorted_e, pos, keep, token = _dispatch_indices(top_e, c, cap)
    local_lo = local_offset * n_local
    se = sorted_e.to(torch.int64)
    is_local = keep & (se >= local_lo) & (se < local_lo + n_local)
    slot = (se - local_lo) * cap + torch.clamp_max(pos, cap - 1).to(torch.int64)
    safe_slot = torch.where(is_local, slot, torch.full_like(slot, n_local * cap))
    tok = token.to(torch.int64)
    gathered = x[tok] * is_local[:, None].to(x.dtype)            # (T*K, d)
    buf = x.new_zeros((n_local * cap + 1, d)).index_put((safe_slot,), gathered)  # unique slots
    xe = buf[:-1].reshape(n_local, cap, d)

    ye = _expert_ffn(xe, w1, w3, w2)                             # (E_loc, C, d)
    back = ye.reshape(-1, d)[torch.clamp_max(safe_slot, n_local * cap - 1)]
    back = back * is_local[:, None].to(back.dtype)
    wsorted = top_p.reshape(-1)[order.to(torch.int64)].to(back.dtype)
    return _combine(back * wsorted[:, None], order, t, c.top_k)


def _moe_local(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor, c: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route tokens (T, d), then every expert's output: -> (routed output, aux)."""
    top_e, top_p, aux = _route(x, router, c)
    return _experts_local(x, top_e, top_p, w1, w3, w2, c, n_local=c.n_experts), aux


def shard0_aux(aux: torch.Tensor, mesh, dp_axes) -> torch.Tensor:
    """The JAX mesh MoE's aux from each data shard's ``aux``: the value of
    data shard 0 (``shard_map``'s replicated output is device 0's) and the
    gradient of the mean over the shards (ROADMAP C31)."""
    mean = M.psum(aux, mesh, dp_axes) / M.axis_size(mesh, dp_axes)
    first = M.unshard_tensor(aux.detach()[None], P(M.as_axes(dp_axes)), mesh)[0]
    return mean + (first - mean).detach()


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, c: MoEConfig, *,
            mesh=None, dp_axes: Tuple[str, ...] = ("data",), tp_axis: str = "model"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over flattened tokens (T, d). Returns (out (T, d), aux loss
    scalar).

    With ``mesh`` (a ``DeviceMesh`` of :func:`repro_torch.launch.mesh.
    make_model_mesh`): ``x`` is this rank's data shard of the tokens (the
    same on every rank of ``tp_axis``), ``params`` its shards under
    :func:`param_specs`, and the output its tokens' rows."""
    if mesh is None:
        out, aux = _moe_local(x, params["router"], params["w1"], params["w3"], params["w2"], c)
        if c.n_shared:
            h = F.silu(dense(x, params["sw1"])) * dense(x, params["sw3"])
            out = out + dense(h, params["sw2"])
        return out, aux
    n_tp = M.axis_size(mesh, tp_axis)
    if c.n_experts % n_tp:
        raise ValueError(f"{c.n_experts} experts not divisible by tp={n_tp}")
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if c.shard_ff_over_data:
        # ZeRO-3: the expert hidden dim gathered at use
        w1 = M.all_gather(w1, mesh, "data", dim=2)
        w3 = M.all_gather(w3, mesh, "data", dim=2)
        w2 = M.all_gather(w2, mesh, "data", dim=1)
    # routing on the replicated tokens: its gradient is whole on every rank
    top_e, top_p, aux = _route(x, params["router"], c)
    xv, pv = M.pvary(x, mesh, tp_axis), M.pvary(top_p, mesh, tp_axis)
    out = _experts_local(xv, top_e, pv, w1, w3, w2, c, n_local=c.n_experts // n_tp,
                         local_offset=M.axis_index(mesh, tp_axis))
    if c.n_shared:
        h = F.silu(dense(xv, params["sw1"])) * dense(xv, params["sw3"])
        out = out + dense(h, params["sw2"])
    return M.psum(out, mesh, tp_axis), shard0_aux(aux, mesh, dp_axes)


def moe_ffn_ref(params: Dict[str, torch.Tensor], x: torch.Tensor, c: MoEConfig) -> torch.Tensor:
    """Dense oracle: every expert computed for every token (tests only).
    Matches ``moe_ffn`` when no pair exceeds the capacity."""
    top_e, top_p, _ = _route(x, params["router"], c)
    h = F.silu(torch.einsum("td,edf->tef", x, params["w1"].to(x.dtype)))
    h = h * torch.einsum("td,edf->tef", x, params["w3"].to(x.dtype))
    ye = torch.einsum("tef,efd->ted", h, params["w2"].to(x.dtype))  # (T, E, d)
    combine = torch.zeros((x.shape[0], c.n_experts), dtype=x.dtype, device=x.device)
    for k in range(c.top_k):
        combine = combine + (F.one_hot(top_e[:, k].to(torch.int64), c.n_experts).to(x.dtype)
                             * top_p[:, k:k + 1].to(x.dtype))
    out = torch.einsum("te,ted->td", combine, ye)
    if c.n_shared:
        hs = F.silu(dense(x, params["sw1"])) * dense(x, params["sw3"])
        out = out + dense(hs, params["sw2"])
    return out
