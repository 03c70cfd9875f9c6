"""Compiled spec->arch batch adaptation: the stage->model boundary.

A compiled :class:`~repro_torch.fe.featureplan.FeaturePlan` emits a
spec-dependent ``batch_*`` layout; an arch config usually wants a different
width, so fields are remapped / re-hashed into the config's vocabularies and
missing blocks are synthesized. :func:`compile` derives all of that at
compile time into a :class:`ModelFeed` (static remap indices, the per-field
vocab modulo vector, the dense / sequence synthesis plan); its
:meth:`ModelFeed.apply` is a handful of torch ops on the batch's device,
bit for bit what the JAX package's ``ModelFeed.apply`` computes.

:meth:`ModelFeed.make_step` wraps a train step into the stage->train
boundary step: ``apply`` runs inside the step call (no ``torch.compile``;
eager torch ops are the port's fused form), the step updates params in
place where the JAX step donates them, and a CUDA event recorded after each
step goes to the device feeder's fence, so staged arenas are reused only
after the step that read them.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.embedding.dedup import expected_unique
from repro_torch.fe.compiler import OutputLayout, field_slot, field_slots
from repro_torch.obs.trace import get_tracer


class ModelFeedError(ValueError):
    """A batch (or config) violates the compiled adaptation contract."""


# ------------------------------------------------------- capacity heuristic
def dedup_capacity_hint(cfg, rows: int, *, mode: str = "worst",
                        safety: float = 1.15, multiple: int = 64) -> int:
    """Working-set capacity for a batch of ``rows`` instances.

    ``mode="worst"`` (default) is the exact upper bound on unique packed
    ids — ``sum_f min(rows, vocab_f)`` plus the behavior-sequence field for
    bst — so dedup can never overflow as long as batches respect the rows
    hint. ``mode="expected"`` uses the uniform-draw expectation
    ``E[unique] = v(1 - (1 - 1/v)^n`` (x ``safety``), capped at the worst
    case. The result is rounded up to ``multiple``.
    """
    rows = int(rows)
    if rows <= 0:
        raise ModelFeedError(f"rows must be > 0, got {rows}")
    vocabs = cfg.vocab_sizes[:cfg.n_sparse]
    seq_rows = rows * (cfg.seq_len + 1) if cfg.kind == "bst" else 0
    worst = sum(min(rows, v) for v in vocabs)
    # Behavior-sequence ids are produced modulo vocab_sizes[0], NOT the item
    # field's vocab — bound with the id space they actually range over.
    if seq_rows:
        worst += min(seq_rows, cfg.vocab_sizes[0])
    if mode == "worst":
        cap = worst
    elif mode == "expected":
        exp = sum(expected_unique(rows, v) for v in vocabs)
        if seq_rows:
            exp += expected_unique(seq_rows, cfg.vocab_sizes[0])
        cap = min(worst, int(exp * safety) + 1)
    else:
        raise ModelFeedError(f"mode must be 'worst' or 'expected', got {mode!r}")
    return max(multiple, -(-cap // multiple) * multiple)


# ------------------------------------------------------------------- stats
@dataclasses.dataclass
class TrainFeedStats:
    """The train-feed tier: where the stage->train boundary's time went
    (filled by :meth:`ModelFeed.make_step`)."""

    steps: int = 0
    fused_steps: int = 0        # steps whose adaptation ran inside the train step
    adapt_seconds: float = 0.0  # host time preparing the feed
    adapt_dispatches: int = 0   # eager device dispatches spent adapting
    unique_ids: int = 0         # sum over steps of the dedup'd working-set count
    total_ids: int = 0          # sum over steps of ids referenced (batch x fields)
    overflows: int = 0          # steps whose unique count saturated the capacity
    local_unique_ids: int = 0   # mesh two-stage dedup: stage-1 uniques

    @property
    def pool_ratio(self) -> float:
        """stage-1 unique ids / referenced ids — how much the local dedup
        shrinks the cross-device id pool before the global unique (0 when
        the step reports no stage-1 counts, i.e. off the mesh)."""
        return self.local_unique_ids / max(self.total_ids, 1)

    @property
    def unique_ratio(self) -> float:
        """unique ids / referenced ids — the dedup win ([37]: table traffic
        is proportional to this, not to batch x fields)."""
        return self.unique_ids / max(self.total_ids, 1)

    def summary(self) -> str:
        return (f"steps={self.steps} (fused={self.fused_steps}) "
                f"adapt={self.adapt_seconds:.3f}s "
                f"unique_ratio={self.unique_ratio:.3f} "
                f"overflows={self.overflows}")


# --------------------------------------------------------------- the plan
@dataclasses.dataclass
class ModelFeed:
    """Compile-time spec->arch adaptation plan (build via :func:`compile`)."""

    config: Any                       # arch config, dedup capacity tuned
    slots: Tuple[str, ...]            # env slots apply() consumes
    split: bool                       # consume per-field batch_field_NN vectors
    n_spec_fields: int
    field_sources: np.ndarray         # (n_model_fields,) spec field per model field
    vocab: np.ndarray                 # (n_model_fields,) int32 modulo vector
    dense_from: Optional[str]         # "batch_dense" | "sparse" | None
    seq_from: Optional[str]           # "batch_seq_ids" | "sparse" | None
    dedup_capacity: int
    stats: TrainFeedStats = dataclasses.field(default_factory=TrainFeedStats)

    # ------------------------------------------------------------- select
    def select(self, env: Mapping[str, Any]) -> Dict[str, Any]:
        """Filter an environment down to the slots :meth:`apply` consumes,
        validating the static shape contract."""
        try:
            feed = {s: env[s] for s in self.slots}
        except KeyError as e:
            raise ModelFeedError(
                f"batch is missing adapted slot {e.args[0]!r} (feed slots: "
                f"{self.slots}; batch slots: "
                f"{sorted(k for k in env if k.startswith('batch_'))})"
            ) from None
        width = (feed[field_slot(0)].ndim if self.split
                 else feed["batch_sparse"].shape[1])
        want = 1 if self.split else self.n_spec_fields
        if width != want:
            raise ModelFeedError(
                f"sparse feed shape mismatch: got width {width}, compiled "
                f"for {want} ({'split' if self.split else 'packed'} layout)")
        return feed

    # -------------------------------------------------------------- apply
    def apply(self, feed: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Adapt one feed (see :meth:`select`) to a model batch on the
        feed's device. Ids use floor-mod (``torch.remainder``), as ``%`` in
        the JAX package does."""
        cfg = self.config
        if self.split:
            fields = [feed[field_slot(i)] for i in range(self.n_spec_fields)]
            dev = fields[0].device
            sel = torch.stack([fields[i] for i in self.field_sources], dim=1)
            packed = (torch.stack(fields, dim=1)
                      if "sparse" in (self.dense_from, self.seq_from) else None)
        else:
            packed = feed["batch_sparse"]
            dev = packed.device
            sel = packed[:, torch.as_tensor(self.field_sources, device=dev)]
        vocab = torch.as_tensor(self.vocab, device=dev)
        batch: Dict[str, torch.Tensor] = {
            "sparse": torch.remainder(sel.to(torch.int32), vocab).to(torch.int32),
            "label": feed["batch_label"].to(torch.float32),
        }
        if self.dense_from is not None:
            if self.dense_from == "batch_dense":
                dense = feed["batch_dense"].to(torch.float32)
            else:
                dense = torch.log1p(packed.to(torch.float32))
            reps = -(-cfg.n_dense // dense.shape[1])  # ceil
            batch["dense"] = dense.repeat(1, reps)[:, :cfg.n_dense]
        if self.seq_from is not None:
            seq = (feed["batch_seq_ids"] if self.seq_from == "batch_seq_ids"
                   else packed)
            reps = -(-cfg.seq_len // seq.shape[1])
            batch["seq"] = torch.remainder(
                seq.repeat(1, reps)[:, :cfg.seq_len].to(torch.int32),
                cfg.vocab_sizes[0]).to(torch.int32)
        return batch

    def model_ids_np(self, env: Mapping[str, Any]
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host twin of :meth:`apply`'s *id* arithmetic: the model batch's
        ``sparse`` (and bst ``seq``) blocks, as numpy, straight from a
        pre-staging env.

        Integer remap + modulo only, so the values are bit for bit the
        device path's; the hierarchical-PS prefetch stage
        (:class:`repro_torch.embedding.psfeed.HierarchyFeed`) uses this to
        build the working set *before* the batch reaches the train step. A
        slot held as a CUDA tensor is copied to the host on the current
        stream first.
        """
        cfg = self.config
        if self.split:
            fields = [_host(env[field_slot(i)]) for i in range(self.n_spec_fields)]
            sel = np.stack([fields[i] for i in self.field_sources], axis=1)
            packed = (np.stack(fields, axis=1)
                      if self.seq_from == "sparse" else None)
        else:
            packed = _host(env["batch_sparse"])
            sel = packed[:, self.field_sources]
        sparse = (sel % self.vocab).astype(np.int32)
        seq = None
        if self.seq_from is not None:
            src = (_host(env["batch_seq_ids"])
                   if self.seq_from == "batch_seq_ids" else packed)
            reps = -(-cfg.seq_len // src.shape[1])
            seq = (np.tile(src, (1, reps))[:, :cfg.seq_len]
                   % cfg.vocab_sizes[0]).astype(np.int32)
        return sparse, seq

    # --------------------------------------------------------------- step
    def make_step(self, train_step: Callable, *,
                  fence_cb: Optional[Callable[[Optional[torch.cuda.Event]], None]] = None,
                  extra_slots: Tuple[str, ...] = ()):
        """Wrap a ``(params, opt_state, batch) -> (params, opt_state,
        metrics)`` train step into the boundary step ``(params, opt_state,
        env) -> (params, opt_state, metrics)``.

        :meth:`apply` runs inside the step call, and the step updates params
        and optimizer state in place (the port's form of the JAX step's
        buffer donation: use the returned ones). ``fence_cb`` is called
        after every step with a CUDA event recorded on the current stream
        behind the step's work (``None`` on the CPU); pass
        :meth:`~repro_torch.core.devicefeed.DeviceFeeder.donation_fence` so
        the feeder rewrites a staged arena only after the step that read it.

        ``extra_slots`` names env slots forwarded *verbatim* into the train
        step's batch, bypassing :meth:`apply`: the hierarchical-PS backend
        rides its pulled working-set tensors (``_ws_rows``/``_ws_unique``/...)
        through the boundary this way. A missing one raises
        :class:`ModelFeedError`.

        The returned callable carries ``feed_stats`` (this plan's
        :class:`TrainFeedStats`).
        """
        stats = self.stats
        extra_slots = tuple(extra_slots)

        def _select_with_extras(env):
            feed = self.select(env)
            try:
                feed.update({k: env[k] for k in extra_slots})
            except KeyError as e:
                raise ModelFeedError(
                    f"batch is missing extra slot {e.args[0]!r} (extra "
                    f"slots: {extra_slots}) — is the working-set prefetch "
                    f"stage wired in?") from None
            return feed

        def step(params, opt_state, env):
            tracer = get_tracer()
            w0 = tracer.now_ns() if tracer.enabled else 0
            t0 = time.perf_counter()
            feed = _select_with_extras(env)
            stats.fused_steps += 1
            stats.adapt_seconds += time.perf_counter() - t0
            if tracer.enabled:
                tracer.complete("train.adapt", w0, tracer.now_ns(), fused=True)
            batch = self.apply(feed)
            batch.update({k: feed[k] for k in extra_slots})
            new_params, new_opt, metrics = train_step(params, opt_state, batch)
            stats.steps += 1
            # Register the fence BEFORE reading metric values: _record waits
            # for the step, and the feeder may need this step's fence.
            if fence_cb is not None:
                fence = None
                if batch["label"].device.type == "cuda":
                    fence = torch.cuda.Event()
                    fence.record(torch.cuda.current_stream(batch["label"].device))
                fence_cb(fence)
            self._record(metrics)
            return new_params, new_opt, metrics

        step.feed_stats = stats
        return step

    def _record(self, metrics: Mapping[str, Any]) -> None:
        u = metrics.get("unique")
        if u is None:
            return  # non-working-set step
        u = int(u)
        self.stats.unique_ids += u
        n = metrics.get("n_ids")
        if n is not None:
            self.stats.total_ids += int(n)
        lu = metrics.get("local_unique")
        if lu is not None:
            self.stats.local_unique_ids += int(lu)
        if self.dedup_capacity and u >= self.dedup_capacity:
            if self.stats.overflows == 0:
                warnings.warn(
                    f"dedup working set saturated (unique={u} >= capacity="
                    f"{self.dedup_capacity}): ids beyond the capacity are "
                    f"silently dropped from the working set — raise the "
                    f"rows hint / dedup_capacity", RuntimeWarning,
                    stacklevel=2)
            self.stats.overflows += 1


def _host(val: Any) -> np.ndarray:
    """A slot's values as a host array (a tensor on the card is copied)."""
    if isinstance(val, torch.Tensor):
        return val.cpu().numpy()
    return np.asarray(val)


# ----------------------------------------------------------------- compile
def compile(plan, cfg, *, split_sparse_fields: bool = False,
            rows_hint: Optional[int] = None, capacity_mode: str = "worst",
            safety: float = 1.15) -> ModelFeed:
    """Derive the :class:`ModelFeed` adaptation plan for ``plan`` x ``cfg``.

    ``plan`` is a compiled :class:`~repro_torch.fe.featureplan.FeaturePlan`
    (or a bare :class:`~repro_torch.fe.compiler.OutputLayout`).
    ``split_sparse_fields`` selects the per-field ``batch_field_NN`` feed
    form. When ``cfg.dedup_capacity`` is 0 and ``rows_hint`` is given, the
    returned plan's :attr:`ModelFeed.config` carries a
    :func:`dedup_capacity_hint`-tuned capacity.
    """
    layout: OutputLayout = getattr(plan, "layout", plan)
    emitted = set(getattr(plan, "output_slots", ())
                  or (name for name, *_ in layout.feed_slots()))
    if layout.n_sparse_fields <= 0 or "batch_sparse" not in emitted:
        raise ModelFeedError(
            f"model feed needs a sparse block; layout emits {sorted(emitted)}")
    if getattr(cfg, "n_sparse", 0) <= 0:
        raise ModelFeedError("arch config has no sparse fields")

    n_spec = layout.n_sparse_fields
    field_sources = np.arange(cfg.n_sparse) % n_spec
    vocab = np.asarray(cfg.vocab_sizes[:cfg.n_sparse], np.int32)
    dense_from = None
    if cfg.n_dense:
        dense_from = ("batch_dense" if "batch_dense" in emitted else "sparse")
    seq_from = None
    if cfg.kind == "bst":
        seq_from = ("batch_seq_ids" if "batch_seq_ids" in emitted
                    else "sparse")

    slots = ["batch_label"]
    slots.extend(field_slots(n_spec) if split_sparse_fields
                 else ("batch_sparse",))
    if dense_from == "batch_dense":
        slots.append("batch_dense")
    if seq_from == "batch_seq_ids":
        slots.append("batch_seq_ids")

    if getattr(cfg, "dedup_capacity", 0) == 0 and rows_hint:
        cfg = dataclasses.replace(
            cfg, dedup_capacity=dedup_capacity_hint(
                cfg, rows_hint, mode=capacity_mode, safety=safety))

    return ModelFeed(
        config=cfg,
        slots=tuple(slots),
        split=split_sparse_fields,
        n_spec_fields=n_spec,
        field_sources=field_sources,
        vocab=vocab,
        dense_from=dense_from,
        seq_from=seq_from,
        dedup_capacity=int(getattr(cfg, "dedup_capacity", 0)),
    )
