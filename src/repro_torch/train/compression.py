"""Gradient compression for cross-pod reduction (distributed optimization).

At 2+ pods the inter-pod links are the scarce resource (data-center network
vs in-pod NVLink), so the cross-pod gradient all-reduce benefits from
compression:

* ``bf16_compress`` — cast fp32 grads to bf16 for the wire (2x), with
  **error feedback** (residual carrying) so quantization error is not lost
  but applied next step [Seide et al. 2014; 1-bit SGD lineage].
* ``int8_compress`` — per-tensor scale + int8 (4x), also with error feedback.
* ``hierarchical_psum`` — the per-rank body of the two-level all-reduce on
  the ``('pod', 'data')`` process groups of a
  :class:`~torch.distributed.device_mesh.DeviceMesh`: reduce-scatter inside
  the pod, compressed all-gather + **fp32 local accumulation** across pods,
  all-gather inside the pod. Inter-pod bytes drop by (pod_size x
  compression) vs a flat all-reduce, quantization error is carried per
  rank in a residual the caller threads through its optimizer state, and
  the sum itself is never computed in reduced precision — only the wire is.
* :class:`CommPlan` / :class:`CommStats` — the deterministic byte model of
  one mesh train step (exchange / dedup pool / grad all-reduce), the
  source of the ``comm`` metrics tier; integer arithmetic, byte for byte
  the JAX package's.

The codecs take a tensor, or a dict of tensors (the JAX package's trees
are dicts here). Collectives are the list forms ``dist.reduce_scatter`` and
``dist.all_gather``, which NCCL and gloo both take on every torch the port
supports.

Byte model (per device, per step). A flat all-reduce of ``n`` fp32
elements moves every element across the inter-pod boundary twice
(reduce + broadcast): ``2 * n * 4`` bytes. The hierarchical scheme
reduce-scatters inside the pod first, so only ``n / pod_size`` elements
per device cross pods, at the codec's wire width: ``2 * (n / pod_size) *
itemsize``. The ratio is ``pod_size * 4 / itemsize`` — pod_size x 2 for
bf16, pod_size x 4 for int8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: codec name -> wire bytes per element
WIRE_ITEMSIZE = {None: 4, "bf16": 2, "int8": 1}


def codec_name(compress: Any) -> Optional[str]:
    """Normalize a ``compress`` argument (bool | str | None) to a codec name.

    ``True`` keeps the historical meaning (bf16 wire); ``False``/``None``/
    ``"off"``/``"none"`` disable compression.
    """
    if compress in (None, False, "off", "none"):
        return None
    if compress is True:
        return "bf16"
    if compress in ("bf16", "int8"):
        return compress
    raise ValueError(f"unknown codec {compress!r} (bf16|int8|off)")


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over a tensor, or over the leaves of a dict of tensors."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# ------------------------------------------------------- codecs (+feedback)
def bf16_compress(grads: Any, residual: Optional[Any] = None) -> Tuple[Any, Any]:
    """fp32 -> bf16 with error feedback. Returns (wire_grads, new_residual)."""
    if residual is None:
        residual = _tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    adjusted = _tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    wire = _tree_map(_bf16_encode, adjusted)
    new_residual = _tree_map(lambda a, w: a - w.to(torch.float32), adjusted, wire)
    return wire, new_residual


def bf16_decompress(wire: Any) -> Any:
    return _tree_map(lambda w: w.to(torch.float32), wire)


# The JAX codec runs under jit, where XLA divides by the constant 127 as a
# multiply by its float32 reciprocal and contracts ``a - q * s`` into one
# FMA (ROADMAP C5); the port computes both the same way, bit for bit, on
# the CPU and on the card.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _bf16_encode(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16)


def _int8_encode(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale and int8 codes: ``round(a / scale)`` clipped to
    ±127, rounding half to even (``jnp.round`` and ``torch.round`` agree)."""
    scale = torch.clamp(a.abs().max(), min=1e-30) * _INV_127
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_residual(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``a - q * scale`` rounded once, as XLA's FMA gives it: in float64
    both the product (8 x 24 bits) and the difference (|a - q s| <= s / 2)
    are exact, so the one rounding to float32 is the FMA's on any device."""
    return (a.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)


def int8_compress(grads: Any, residual: Optional[Any] = None) -> Tuple[Any, Any, Any]:
    """fp32 -> (int8, scale) with error feedback."""
    if residual is None:
        residual = _tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    adjusted = _tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    qs = _tree_map(_int8_encode, adjusted)
    if isinstance(qs, dict):
        wire = {k: v[0] for k, v in qs.items()}
        scales = {k: v[1] for k, v in qs.items()}
    else:
        wire, scales = qs
    new_residual = _tree_map(_int8_residual, adjusted, wire, scales)
    return wire, scales, new_residual


def int8_decompress(wire: Any, scales: Any) -> Any:
    return _tree_map(lambda q, s: q.to(torch.float32) * s, wire, scales)


def compressed_bytes(tree: Any) -> int:
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    return int(sum(int(np.prod(tuple(t.shape))) * t.element_size() for t in leaves))


# ------------------------------------------------ hierarchical cross-pod sum
def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``psum_scatter(tiled=True)`` over ``group``: this rank's block of the
    elementwise sum of every rank's ``x`` (``x.shape[0]`` divides by the
    group's size)."""
    out = torch.empty_like(x[: x.shape[0] // dist.get_world_size(group)])
    dist.reduce_scatter(out, list(x.chunk(dist.get_world_size(group))), group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather(axis=0)`` over ``group``: every rank's ``x``, stacked
    on a new leading axis in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def hierarchical_psum(x: torch.Tensor, mesh, *, pod_axis: str = "pod",
                      inner_axis: str = "data", compress: Any = True,
                      residual: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Two-level all-reduce of a 1-D fp32 ``x`` over ``mesh``'s process
    groups, called by every rank of the mesh (the body the JAX function
    runs inside ``shard_map``).

    reduce_scatter(inner) -> [encode] all_gather(pod) of the compressed
    shards, decoded and **summed locally in fp32** -> all_gather(inner).
    Inter-pod traffic: N/inner_size elements (xN less) at the codec's wire
    width (x2 bf16, x4 int8).

    ``compress`` selects the codec (``"bf16"`` | ``"int8"`` | off; ``True``
    means bf16). ``residual`` is this rank's error-feedback carry from the
    previous step — shaped like the reduce-scattered shard
    (``x.shape[0] / inner_size``) — added to the shard before
    quantization, so the wire error is not lost but applied next step. The
    caller owns its persistence. With no codec, the residual passes through
    untouched.

    Returns ``(reduced, new_residual)``. With ``compress`` off on a 1x1
    mesh every collective is a copy, so the result is bitwise ``x``.
    """
    codec = codec_name(compress)
    pod, inner = mesh.get_group(pod_axis), mesh.get_group(inner_axis)
    shard = _reduce_scatter(x, inner)
    if codec is None:
        reduced = shard.clone()
        dist.all_reduce(reduced, group=pod)
        new_residual = residual
    else:
        adjusted = shard.to(torch.float32)
        if residual is not None:
            adjusted = adjusted + residual
        if codec == "bf16":
            wire = _bf16_encode(adjusted)
            # all-gather the *compressed* shards (the inter-pod wire), then
            # decode and accumulate locally in fp32
            got = _all_gather(wire, pod)                    # (P, n/K) bf16
            reduced = torch.sum(got.to(torch.float32), dim=0)
            new_residual = adjusted - wire.to(torch.float32)
        else:  # int8: the per-call scale rides along (4 bytes vs n/K payload)
            q, scale = _int8_encode(adjusted)
            got = _all_gather(q, pod)                       # (P, n/K) int8
            scales = _all_gather(scale.reshape(1), pod)     # (P, 1)
            reduced = torch.sum(got.to(torch.float32) * scales, dim=0)
            new_residual = _int8_residual(adjusted, q, scale)
        reduced = reduced.to(x.dtype)
    out = _all_gather(reduced, inner).reshape(-1)
    return out, new_residual


def flat_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Baseline: one flat all-reduce over every rank of ``mesh`` (a train
    mesh spans the default process group, :func:`repro_torch.launch.mesh.
    make_train_mesh`)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"flat_psum needs a mesh over all {dist.get_world_size()} ranks, "
                         f"got {mesh.size()}")
    out = x.clone()
    dist.all_reduce(out)
    return out


# ------------------------------------------------------- comm byte accounting
@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Static per-step collective-byte model of one mesh train step.

    All numbers are *per device, per step*, derived from shapes alone.
    Three collectives per step:

    * **dedup pool** — all-gather of each device's FILL-padded local
      uniques (stage 1 -> stage 2 of the two-stage dedup), int32;
    * **exchange** — replication of the working set (rows + Adagrad
      accumulators) from the row shards, fp32 (parameters are never
      quantized);
    * **allreduce** — the gradient reduction (working-set grads + flat
      dense grads), at the codec's wire width when hierarchical.
    """

    n_pods: int
    inner: int                       # devices per pod (the "pod_size")
    codec: Optional[str]             # None | "bf16" | "int8"
    hierarchical: bool
    allreduce_elems: int             # grad elements reduced per step
    exchange_elems: int              # working-set fp32 elements replicated
    dedup_pool_elems: int            # local-unique int32 ids pooled (per dev)
    flat_id_elems: int               # raw ids a flat (no local stage) dedup
    #                                  would pool per device instead

    @staticmethod
    def for_step(*, n_pods: int, inner: int, compress: Any,
                 hierarchical: bool, capacity: int, embed_dim: int,
                 n_dense_elems: int, local_capacity: int,
                 ids_per_device: int) -> "CommPlan":
        return CommPlan(
            n_pods=n_pods, inner=inner, codec=codec_name(compress),
            hierarchical=hierarchical,
            allreduce_elems=capacity * embed_dim + n_dense_elems,
            exchange_elems=capacity * embed_dim + capacity,
            dedup_pool_elems=local_capacity,
            flat_id_elems=ids_per_device)

    # ------------------------------------------------------------ structure
    @property
    def n_devices(self) -> int:
        return self.n_pods * self.inner

    @property
    def wire_itemsize(self) -> int:
        return WIRE_ITEMSIZE[self.codec]

    def _interpod(self, elems: int, itemsize: int, *, hier: bool) -> int:
        """Inter-pod bytes of one reduction of ``elems`` elements."""
        if self.n_pods <= 1:
            return 0
        if not hier:
            return 2 * elems * 4          # flat fp32 all-reduce
        per_dev = -(-elems // self.inner)  # reduce-scattered shard
        extra = 8 if itemsize == 1 else 0  # int8 per-call scale, both ways
        return 2 * per_dev * itemsize + extra

    # ------------------------------------------- per-collective inter-pod B
    @property
    def allreduce_interpod_bytes(self) -> int:
        return self._interpod(self.allreduce_elems, self.wire_itemsize,
                              hier=self.hierarchical)

    @property
    def allreduce_interpod_bytes_flat(self) -> int:
        return self._interpod(self.allreduce_elems, 4, hier=False)

    @property
    def exchange_interpod_bytes(self) -> int:
        # parameters stay fp32 on the wire; hierarchy still wins x pod_size
        return self._interpod(self.exchange_elems, 4,
                              hier=self.hierarchical)

    @property
    def exchange_interpod_bytes_flat(self) -> int:
        return self._interpod(self.exchange_elems, 4, hier=False)

    @property
    def dedup_interpod_bytes(self) -> int:
        """Pool gather: ids received from devices in OTHER pods, int32."""
        other_pods = self.n_devices - self.inner
        return other_pods * self.dedup_pool_elems * 4

    @property
    def dedup_interpod_bytes_flat(self) -> int:
        """A single-stage dedup would pool every raw id instead."""
        other_pods = self.n_devices - self.inner
        return other_pods * self.flat_id_elems * 4

    # ------------------------------------------------------------ roll-ups
    @property
    def interpod_bytes_per_step(self) -> int:
        return (self.allreduce_interpod_bytes + self.exchange_interpod_bytes
                + self.dedup_interpod_bytes)

    @property
    def interpod_bytes_per_step_flat(self) -> int:
        return (self.allreduce_interpod_bytes_flat
                + self.exchange_interpod_bytes_flat
                + self.dedup_interpod_bytes_flat)

    @property
    def allreduce_reduction(self) -> float:
        """flat / hierarchical inter-pod bytes of the gradient all-reduce:
        ``pod_size * 4 / wire_itemsize`` (pod_size x 2 for bf16)."""
        hier = self.allreduce_interpod_bytes
        if hier <= 0:
            return 1.0
        return self.allreduce_interpod_bytes_flat / hier

    @property
    def interpod_reduction(self) -> float:
        hier = self.interpod_bytes_per_step
        if hier <= 0:
            return 1.0
        return self.interpod_bytes_per_step_flat / hier

    def as_metrics(self):
        from repro_torch.obs.metrics import harvest
        return harvest(self)


@dataclasses.dataclass
class CommStats:
    """The ``comm`` tier: collective traffic of the mesh train loop.

    Static per-step bytes come from the :class:`CommPlan`; the driver's
    step function calls :meth:`on_step` once per step (single writer: the
    train loop), so totals scale with steps. Attached to
    :class:`~repro_torch.core.pipeline.PipelineStats.comm` by the runners
    (duck-typed off the train step's ``comm_stats`` attribute).
    """

    plan: CommPlan
    steps: int = 0

    def on_step(self) -> None:
        self.steps += 1

    @property
    def interpod_bytes_total(self) -> int:
        return self.steps * self.plan.interpod_bytes_per_step

    @property
    def interpod_bytes_total_flat(self) -> int:
        return self.steps * self.plan.interpod_bytes_per_step_flat

    def as_metrics(self):
        from repro_torch.obs.metrics import harvest
        out = {f"plan_{k}": v for k, v in harvest(self.plan).items()}
        out.update(harvest(self))
        return out

    def summary(self) -> str:
        p = self.plan
        codec = p.codec or "off"
        return (f"mesh {p.n_pods}x{p.inner} codec={codec} "
                f"interpod/step={p.interpod_bytes_per_step / 2**10:.1f}KiB "
                f"(flat {p.interpod_bytes_per_step_flat / 2**10:.1f}KiB, "
                f"x{p.interpod_reduction:.1f} less; allreduce "
                f"x{p.allreduce_reduction:.1f}) steps={self.steps}")
