"""Hierarchical parameter server: HBM <- host DRAM <- SSD (paper §II-B, [37]).

Three tiers, upper acting as a cache of lower:

* **SSD tier** — the full table as a file-backed ``np.memmap`` (the 10TB+
  production table that fits no single memory).
* **Host tier** — a cache of recently-used rows in host DRAM, evicted in
  approximate-LRU order (recency is stamped per *pull*, not per row — all
  rows touched by one pull share a stamp, so a whole working set ages out
  together). The tier is fully vectorized: one batched id->slot lookup, one
  fancy-indexed read from the slot buffer for hits, one fancy-indexed SSD
  gather for misses — no per-row Python loop on the pull path.
* **Device tier** — the per-batch working set, pulled by ``pull()`` after
  dedup and pushed back by ``push()`` after the optimizer step.

This is deliberately a *host-side software* component: JAX sees only the
dense working-set array, so the training step stays jit/pjit-clean. The
pull/push boundary is exactly the paper's CPU<->GPU H2D/D2H seam.

``HierarchicalPS`` is **not** thread-safe; concurrent pull/push callers
(e.g. :class:`repro.embedding.psfeed.HierarchyFeed`'s prefetch and
write-back threads) must serialize access with their own lock.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.embedding.dedup import dedup_np
from repro_torch.obs.metrics import harvest
from repro_torch.obs.trace import NULL_SPAN, get_tracer


@dataclasses.dataclass
class TierStats:
    host_hits: int = 0
    ssd_reads: int = 0
    pulls: int = 0
    pushes: int = 0
    pulled_rows: int = 0
    pushed_rows: int = 0
    evictions: int = 0

    @property
    def host_hit_rate(self) -> float:
        """Fraction of working-set row lookups served from host DRAM."""
        return self.host_hits / max(self.host_hits + self.ssd_reads, 1)

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for :class:`repro.obs.MetricsRegistry`."""
        return harvest(self)

    def summary(self) -> str:
        return (f"pulls={self.pulls} pushes={self.pushes} "
                f"rows={self.pulled_rows}/{self.pushed_rows} "
                f"host_hit_rate={self.host_hit_rate:.3f} "
                f"evictions={self.evictions}")


class HierarchicalPS:
    """File-backed embedding table with a vectorized host row cache.

    ``init_fn(start, stop, rng) -> f32[stop-start, dim]`` overrides the
    default uniform chunk initializer when creating a new table file (the
    driver uses it to colocate the Adagrad accumulator column).
    """

    def __init__(
        self,
        path: str,
        *,
        total_rows: int,
        dim: int,
        host_cache_rows: int = 100_000,
        init_scale: Optional[float] = None,
        seed: int = 0,
        create: bool = True,
        init_fn: Optional[Callable[[int, int, np.random.Generator],
                                   np.ndarray]] = None,
    ) -> None:
        self.total_rows = total_rows
        self.dim = dim
        self.host_cache_rows = host_cache_rows
        self.path = path
        expected_bytes = total_rows * dim * np.dtype(np.float32).itemsize
        if create and not os.path.exists(path):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(total_rows, dim))
            scale = init_scale if init_scale is not None else 1.0 / np.sqrt(dim)
            rng = np.random.default_rng(seed)
            # chunked init so huge tables never materialize in RAM
            step = max(1, (1 << 24) // max(dim, 1))
            for s in range(0, total_rows, step):
                e = min(total_rows, s + step)
                if init_fn is not None:
                    mm[s:e] = np.asarray(init_fn(s, e, rng), np.float32)
                else:
                    mm[s:e] = rng.uniform(-scale, scale, (e - s, dim)).astype(np.float32)
            mm.flush()
            del mm
        else:
            # Opening an existing file: a stale or resized table would
            # silently read garbage rows through the memmap — reject any
            # size mismatch up front.
            actual_bytes = os.path.getsize(path)
            if actual_bytes != expected_bytes:
                raise ValueError(
                    f"PS table file {path!r} does not match shape "
                    f"({total_rows}, {dim}) f32: expected {expected_bytes} "
                    f"bytes, found {actual_bytes} bytes — stale or resized "
                    f"table file? Delete it or fix total_rows/dim")
        self._ssd = np.memmap(path, dtype=np.float32, mode="r+",
                              shape=(total_rows, dim))
        # Vectorized host tier: id -> slot map plus parallel slot arrays.
        # The dict is the only per-row structure left; row payloads move
        # through fancy-indexed numpy ops only.
        cap = max(host_cache_rows, 0)
        self._host_map: Dict[int, int] = {}
        self._host_ids = np.full((cap,), -1, np.int64)      # slot -> row id
        self._host_stamp = np.zeros((cap,), np.int64)       # slot -> last use
        self._host_buf: Optional[np.ndarray] = None         # (cap, dim) lazy
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._tick = 0
        self.stats = TierStats()

    # ------------------------------------------------------------------ pull
    def pull(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fetch the deduped working set for a batch.

        Returns (working_table f32[U, D], unique_ids int64[U], inverse int32[ids.shape]).
        The device trains against ``working_table``; ``inverse`` remaps batch
        slots into it (see ``embedding.dedup``).
        """
        tracer = get_tracer()
        with (tracer.span("ps.pull") if tracer.recording else NULL_SPAN):
            unique, inverse = dedup_np(np.asarray(ids))
            out = self.read_rows(unique)
            self.stats.pulls += 1
            self.stats.pulled_rows += len(unique)
        return out, unique, inverse

    def read_rows(self, unique: np.ndarray) -> np.ndarray:
        """Read-through fetch of already-unique row ids (f32[U, D]).

        One batched host-map lookup, one fancy-indexed hit gather from the
        host buffer, one fancy-indexed SSD gather for the misses (which are
        then cached).
        """
        unique = np.asarray(unique)
        n = len(unique)
        out = np.empty((n, self.dim), np.float32)
        if n == 0:
            return out
        if int(unique.max()) >= self.total_rows or int(unique.min()) < 0:
            raise ValueError(
                f"row ids out of range for table with {self.total_rows} "
                f"rows: min={unique.min()} max={unique.max()}")
        get = self._host_map.get
        slots = np.fromiter((get(int(r), -1) for r in unique),
                            np.int64, count=n)
        hit = slots >= 0
        n_hit = int(hit.sum())
        if n_hit:
            hit_slots = slots[hit]
            out[hit] = self._host_buf[hit_slots]
            self._host_stamp[hit_slots] = self._tick
            self.stats.host_hits += n_hit
        if n_hit < n:
            miss = ~hit
            miss_ids = unique[miss]
            rows = self._ssd[miss_ids]  # single fancy-indexed SSD gather
            out[miss] = rows
            self.stats.ssd_reads += n - n_hit
            self._cache_rows(miss_ids, rows)
        self._tick += 1
        return out

    # ------------------------------------------------------------------ push
    def push(self, unique_ids: np.ndarray, rows: np.ndarray) -> None:
        """Write updated working-set rows back (host cache + SSD write-through).

        ``unique_ids`` must be deduplicated (the pull path's ``unique``).
        """
        ids = np.asarray(unique_ids)
        rows = np.asarray(rows, np.float32)
        tracer = get_tracer()
        with (tracer.span("ps.push", rows=len(ids))
              if tracer.recording else NULL_SPAN):
            self._ssd[ids] = rows
            self._cache_rows(ids, rows)
            self._tick += 1
            self.stats.pushes += 1
            self.stats.pushed_rows += len(ids)

    def flush(self) -> None:
        self._ssd.flush()

    # ------------------------------------------------------------------ util
    def _cache_rows(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Insert/update unique rows in the host tier (vectorized).

        Rows already resident are overwritten in place; new rows take free
        slots first, then evict the least-recently-stamped residents.
        """
        cap = self.host_cache_rows
        if cap <= 0:
            return
        k = len(ids)
        if k > cap:
            # A working set larger than the whole cache: only the tail
            # survives (matches LRU insert order — last inserted wins).
            self.stats.evictions += k - cap
            ids, rows = ids[-cap:], rows[-cap:]
            k = cap
        if self._host_buf is None:
            self._host_buf = np.empty((cap, self.dim), np.float32)
        get = self._host_map.get
        slots = np.fromiter((get(int(r), -1) for r in ids), np.int64, count=k)
        resident = slots >= 0
        if resident.any():
            res_slots = slots[resident]
            self._host_buf[res_slots] = rows[resident]
            self._host_stamp[res_slots] = self._tick
        n_new = k - int(resident.sum())
        if n_new == 0:
            return
        new_mask = ~resident
        take = min(n_new, len(self._free))
        new_slots = np.empty((n_new,), np.int64)
        if take:
            new_slots[:take] = self._free[-take:]
            del self._free[-take:]
        n_evict = n_new - take
        if n_evict:
            # All remaining slots are occupied: evict the n_evict oldest.
            cand = np.flatnonzero(self._host_ids >= 0)
            oldest = np.argpartition(self._host_stamp[cand], n_evict - 1)[:n_evict]
            evict_slots = cand[oldest]
            for rid in self._host_ids[evict_slots]:
                del self._host_map[int(rid)]
            self.stats.evictions += n_evict
            new_slots[take:] = evict_slots
        new_ids = ids[new_mask]
        self._host_ids[new_slots] = new_ids
        self._host_buf[new_slots] = rows[new_mask]
        self._host_stamp[new_slots] = self._tick
        for rid, slot in zip(new_ids, new_slots):
            self._host_map[int(rid)] = int(slot)

    @property
    def host_cache_size(self) -> int:
        return len(self._host_map)
