"""Concurrency annotations: the thread contract of shared pipeline objects.

These decorators attach *declarations* to classes whose instances are
shared across the pipeline's threads (fe-worker, h2d-feeder, loader
readers, main train loop). They are pure metadata — zero runtime cost,
stdlib-only (this module must stay import-light: ``core/devicefeed.py``
imports it, and pulling analyzer machinery here would create an import
cycle through ``fe.compiler``). A copy of the JAX package's
``repro.check.annotations``; the AST checker
:mod:`repro_torch.check.lockset` (a copy of ``repro.check.lockset``)
verifies the declarations against the source.

Conventions
-----------
``@guarded_by("lock", "attr", ...)``
    Every write to ``self.attr`` (or any dotted path under it, e.g.
    ``self.stats.donated`` when ``"stats"`` is declared) that is reachable
    from more than one thread entry point must happen lexically inside
    ``with self.lock:``.

``@shared_entry("method", ...)``
    Marks methods that are thread entry points on the instance — extra
    roots for the checker's reachability walk beyond
    ``threading.Thread(target=self._x)`` targets it discovers on its own.
    Each entry may carry a thread label, ``"feeder:stage"``: entries
    sharing a label run on the same thread (writes reachable from only
    that label never race each other); an unlabeled entry gets its own
    implicit label. Discovered thread targets are labeled
    ``thread:<method>`` and the spawning method ``main``.

``@single_writer("attr", ...)``
    Documents attributes that are intentionally unsynchronized because
    exactly one thread ever writes them (e.g. per-field stats each owned
    by one worker). The checker suppresses LK402 for these but still
    flags them with LK404 if it can prove two distinct entry points write
    them.

Example::

    @guarded_by("_lock", "stats", "_inflight")
    @shared_entry("stage", "flush")
    class DeviceFeeder: ...
"""

from __future__ import annotations

from typing import Dict, Tuple, Type, TypeVar

T = TypeVar("T")

GUARDED_ATTR = "__guarded_by__"
SHARED_ENTRY_ATTR = "__shared_entry__"
SINGLE_WRITER_ATTR = "__single_writer__"


def guarded_by(lock: str, *attrs: str):
    """Declare that writes to ``attrs`` require holding ``self.<lock>``."""
    if not attrs:
        raise ValueError("guarded_by needs at least one attribute name")

    def deco(cls: Type[T]) -> Type[T]:
        table: Dict[str, str] = dict(getattr(cls, GUARDED_ATTR, ()) or {})
        # Copy, never mutate a base class's table in place.
        table = dict(table)
        for a in attrs:
            table[a] = lock
        setattr(cls, GUARDED_ATTR, table)
        return cls

    return deco


def shared_entry(*methods: str):
    """Declare methods invoked from other threads (checker roots)."""
    if not methods:
        raise ValueError("shared_entry needs at least one method name")

    def deco(cls: Type[T]) -> Type[T]:
        prev: Tuple[str, ...] = tuple(getattr(cls, SHARED_ENTRY_ATTR, ()) or ())
        setattr(cls, SHARED_ENTRY_ATTR, tuple(dict.fromkeys(prev + methods)))
        return cls

    return deco


def single_writer(*attrs: str):
    """Declare attributes intentionally owned by exactly one thread."""
    if not attrs:
        raise ValueError("single_writer needs at least one attribute name")

    def deco(cls: Type[T]) -> Type[T]:
        prev: Tuple[str, ...] = tuple(getattr(cls, SINGLE_WRITER_ATTR, ()) or ())
        setattr(cls, SINGLE_WRITER_ATTR, tuple(dict.fromkeys(prev + attrs)))
        return cls

    return deco
