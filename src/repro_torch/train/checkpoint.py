"""Asynchronous checkpointing with atomic commits + restart, over nested
dicts of tensors.

A port of the JAX package's ``repro.train.checkpoint`` with the same
on-disk layout:

* every host writes its own leaf files (``h<id>_leaf<i>.npy``, leaves in
  sorted key order) and a per-host manifest of their key paths;
* writes go to a temp directory and are committed with an atomic rename,
  and the latest-step pointer (``manifest.json``) is replaced atomically,
  so a crash mid-save never corrupts the latest checkpoint;
* ``save_async`` snapshots to host memory before it returns and does disk
  I/O on a background thread — training continues during the write;
* ``latest_step`` / ``restore`` implement restart-from-latest;
* retention keeps the newest K checkpoints and sweeps dead temp files.

Where the JAX state is immutable, the port's train step updates params and
optimizer state in place, so two things differ:

* the snapshot of ``save_async`` is a host copy taken before it returns
  (``.cpu()`` of a CUDA tensor, ``.clone()`` of a CPU one): a reference
  would let the next step change what is being written;
* :meth:`CheckpointManager.restore` writes into the tensors of ``like`` in
  place (the optimizer state and the step's closures hold references to
  them) and returns ``like``'s structure with its non-tensor leaves (the
  optimizer's host step count) replaced.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs of nested dicts in sorted key order, key
    paths spelled as the JAX package's ``keystr`` spells them."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _map(tree: Any, fn: Callable[[Any], Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _snapshot(leaf: Any) -> np.ndarray:
    """A host copy of one leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().cpu() if leaf.device.type != "cpu" else leaf.detach().clone()
        return host.numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0):
        if keep < 1:
            raise ValueError(
                f"keep must be >= 1 (retention keeps the newest K "
                f"checkpoints; keep={keep} would silently disable GC)")
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats = {"saves": 0, "restores": 0, "save_seconds": 0.0,
                      "stale_tmp_swept": 0}
        # A save that crashed before its atomic rename leaves a temp dir
        # behind; sweep this host's stale temps at startup (and on every GC).
        self._sweep_stale_tmp()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, meta: Optional[dict] = None) -> str:
        """Synchronous atomic save of this host's leaves. ``meta`` is a small
        JSON-able dict kept in the latest-step pointer (the mesh the state
        was trained on), read back by :meth:`latest_meta`."""
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp_step_{step:010d}_h{self.host_id}")
        final = self._step_dir(step)
        os.makedirs(tmp, exist_ok=True)
        names = []
        for i, (name, leaf) in enumerate(_flatten(tree)):
            arr = leaf if isinstance(leaf, np.ndarray) else _snapshot(leaf)
            np.save(os.path.join(tmp, f"h{self.host_id}_leaf{i:05d}.npy"), arr)
            names.append(name)
        with open(os.path.join(tmp, f"manifest_h{self.host_id}.json"), "w") as f:
            json.dump({"step": step, "names": names, "host": self.host_id}, f)
        # atomic commit: rename tmp -> final (POSIX rename atomicity)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # The latest-step pointer is written to a temp file and replaced
        # atomically: readers see either the old pointer or the new one.
        manifest_tmp = os.path.join(self.directory, f".{MANIFEST}.h{self.host_id}.tmp")
        with open(manifest_tmp, "w") as f:
            json.dump({"latest_step": step, "meta": dict(meta or {})}, f)
        os.replace(manifest_tmp, os.path.join(self.directory, MANIFEST))
        self._gc()
        self.stats["saves"] += 1
        self.stats["save_seconds"] += time.perf_counter() - t0
        return final

    def save_async(self, step: int, tree: Any, *, meta: Optional[dict] = None) -> None:
        """Snapshot to host memory now; write to disk in the background."""
        self.wait()  # one in-flight save at a time
        snapshot = _map(tree, _snapshot)

        def worker():
            try:
                self.save(step, snapshot, meta=meta)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True, name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, MANIFEST)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(json.load(f)["latest_step"])

    def latest_meta(self) -> dict:
        """The ``meta`` dict saved with the latest checkpoint ({} if none)."""
        path = os.path.join(self.directory, MANIFEST)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return dict(json.load(f).get("meta") or {})

    def restore(self, step: int, like: Any) -> Any:
        """Restore the tree this host saved at ``step`` into ``like``: its
        tensors are overwritten in place (shapes must match), its other
        leaves are replaced in the returned tree."""
        d = self._step_dir(step)
        with open(os.path.join(d, f"manifest_h{self.host_id}.json")) as f:
            names = json.load(f)["names"]
        flat = _flatten(like)
        if [n for n, _ in flat] != names:
            raise ValueError(f"checkpoint at step {step} holds {names}, "
                             f"expected {[n for n, _ in flat]}")
        loaded = {}
        for i, (name, ref) in enumerate(flat):
            arr = np.load(os.path.join(d, f"h{self.host_id}_leaf{i:05d}.npy"))
            if hasattr(ref, "shape") and tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {i} ({name}) shape {arr.shape} != expected "
                    f"{tuple(ref.shape)}")
            loaded[name] = arr
        self.stats["restores"] += 1
        return self._fill(like, loaded, "")

    def _fill(self, like: Any, loaded: dict, path: str) -> Any:
        if isinstance(like, dict):
            return {k: self._fill(v, loaded, f"{path}[{k!r}]") for k, v in like.items()}
        arr = loaded[path]
        if isinstance(like, torch.Tensor):
            with torch.no_grad():
                like.copy_(torch.from_numpy(arr))
            return like
        return arr.item() if arr.ndim == 0 else arr

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like)

    # ------------------------------------------------------------------ util
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _steps_on_disk(self) -> List[int]:
        return sorted(int(d.split("_", 1)[1]) for d in os.listdir(self.directory)
                      if d.startswith("step_"))

    def _sweep_stale_tmp(self) -> None:
        """Remove leftover temp artifacts of crashed saves (this host only).

        Saves are serialized per manager (``save_async`` keeps one in
        flight), so any matching temp found here is a dead save.
        """
        suffix = f"_h{self.host_id}"
        manifest_tmp = f".{MANIFEST}.h{self.host_id}.tmp"
        for d in os.listdir(self.directory):
            path = os.path.join(self.directory, d)
            if d.startswith(".tmp_step_") and d.endswith(suffix):
                shutil.rmtree(path, ignore_errors=True)
                self.stats["stale_tmp_swept"] += 1
            elif d == manifest_tmp:
                try:
                    os.unlink(path)
                    self.stats["stale_tmp_swept"] += 1
                except OSError:
                    pass

    def _gc(self) -> None:
        for s in self._steps_on_disk()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        self._sweep_stale_tmp()
