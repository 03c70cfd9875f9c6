"""Concurrency lockset audit (LK4xx): static checks on the pipeline threads.

The three-thread pipeline (fe-worker -> h2d-feeder -> main train loop, plus
the loader's reader pool) shares mutable state across threads. The
convention in :mod:`repro.check.annotations` declares that state —
``@guarded_by`` names the lock writes must hold, ``@shared_entry`` names
the methods other threads call into, ``@single_writer`` documents
deliberately unsynchronized single-owner fields — and this module verifies
the declarations against the source with ``ast`` alone (no imports of the
audited modules, no execution).

Model
-----
*Entry points* (roots) are methods that start a thread context on the
instance: discovered ``threading.Thread(target=self._x)`` targets (label
``thread:_x``), the spawning method itself (label ``main``), and declared
``@shared_entry`` methods (label prefix before ``:``, defaulting to the
method name). The checker walks the ``self.``-call graph from each root
and tags every reachable method with the root's thread labels.

*Writes* are ``Assign``/``AugAssign``/valued-``AnnAssign`` targets on
dotted ``self.`` paths (subscripts unwrapped: ``self._ring[b] = ...``
writes ``_ring``). A write is *lock-held* when it sits lexically inside
``with self.<lock>:`` — code deferred into nested ``def``/``lambda``
bodies is treated as running without the lock (it executes later).
``__init__``/``__post_init__`` are exempt (single-threaded construction).

Two write paths *conflict* when one is a prefix of the other (rebinding
``self.stats`` conflicts with a reader updating ``self.stats.shards``).
Declarations match by the same prefix rule.

Rules
-----
``LK401`` (error) — a ``self.`` path is written from two or more distinct
    thread labels with no ``guarded_by``/``single_writer`` declaration
    covering it. Undeclared cross-thread mutation is the bug class that
    produced the FeedStats races fixed in this PR; declare it, then hold
    the lock.

``LK402`` (error) — a write to a ``@guarded_by``-declared path outside
    ``with self.<lock>:`` in a method reachable from a thread entry point.
    Regression notes: this rule caught (a) ``DeviceFeeder._await_completion``
    bumping ``stats.donated`` / ``stats.stall_seconds`` without ``_lock``
    while reachable from both the h2d-feeder thread (``stage`` ->
    ``_claim_buffer``) and the main thread (``flush``), and (b)
    ``StreamingLoader.__iter__`` updating ``stats.consumer_stall_seconds``/
    ``stats.max_queue_depth``/``stats.wall_seconds`` (and rebinding
    ``stats``) without ``_lock`` while reader threads update sibling
    fields under it. Both were fixed in this PR by taking the declared
    lock around the writes.

``LK403`` (error) — a declaration that cannot hold: ``guarded_by`` names a
    lock attribute the class never assigns, or ``shared_entry`` names a
    method the class does not define.

``LK404`` (error) — a ``@single_writer`` path provably written from two or
    more distinct thread labels: the single-owner claim is false; guard it
    instead.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.check.findings import Finding

# Audited by default: the files owning the pipeline's thread-shared
# state (relative to the repro package root).
DEFAULT_FILES = ("core/pipeline.py", "core/devicefeed.py", "io/stream.py",
                 "embedding/psfeed.py", "train/fault.py", "io/chaos.py")

_DECOS = {"guarded_by", "shared_entry", "single_writer"}
_CTOR = {"__init__", "__post_init__"}


# --------------------------------------------------------------- AST helpers
def _self_path(node: ast.AST) -> Optional[str]:
    """Dotted attribute path rooted at ``self`` (subscripts unwrapped),
    e.g. ``self._inflight[b]`` -> ``_inflight``; non-self -> None."""
    parts: List[str] = []
    while True:
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
            continue
        break
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None


def _conflicts(a: str, b: str) -> bool:
    """True when writes to paths ``a`` and ``b`` can race (prefix rule)."""
    return a == b or a.startswith(b + ".") or b.startswith(a + ".")


def _deco_call_name(deco: ast.expr) -> Optional[str]:
    fn = deco.func if isinstance(deco, ast.Call) else deco
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _str_args(call: ast.Call) -> List[str]:
    return [a.value for a in call.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)]


# ------------------------------------------------------------- method model
@dataclasses.dataclass
class _Write:
    path: str
    lineno: int
    locks: frozenset  # lock attribute names lexically held


@dataclasses.dataclass
class _Method:
    name: str
    lineno: int
    writes: List[_Write] = dataclasses.field(default_factory=list)
    calls: Set[str] = dataclasses.field(default_factory=set)
    spawns: List[str] = dataclasses.field(default_factory=list)


def _scan_method(fn: ast.AST) -> _Method:
    m = _Method(name=fn.name, lineno=fn.lineno)

    def collect_target(t: ast.expr, lineno: int, locks: frozenset) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                collect_target(el, lineno, locks)
            return
        if isinstance(t, ast.Starred):
            collect_target(t.value, lineno, locks)
            return
        path = _self_path(t)
        if path is not None:
            m.writes.append(_Write(path=path, lineno=lineno, locks=locks))

    def scan(node: ast.AST, locks: frozenset) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # Deferred execution: no lock is guaranteed held when this runs.
            for child in ast.iter_child_nodes(node):
                scan(child, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            held = set(locks)
            for item in node.items:
                p = _self_path(item.context_expr)
                if p is not None:
                    held.add(p)
                scan(item.context_expr, locks)
            for stmt in node.body:
                scan(stmt, frozenset(held))
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                collect_target(t, node.lineno, locks)
        elif isinstance(node, ast.AugAssign):
            collect_target(node.target, node.lineno, locks)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            collect_target(node.target, node.lineno, locks)
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                m.calls.add(f.attr)
            name = _deco_call_name(node)
            if name == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        p = _self_path(kw.value)
                        if p is not None:
                            m.spawns.append(p)
        for child in ast.iter_child_nodes(node):
            scan(child, locks)

    for stmt in fn.body:
        scan(stmt, frozenset())
    return m


# --------------------------------------------------------------- class model
@dataclasses.dataclass
class _ClassInfo:
    name: str
    lineno: int
    guarded: Dict[str, str] = dataclasses.field(default_factory=dict)
    entries: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    single: List[str] = dataclasses.field(default_factory=list)
    methods: Dict[str, _Method] = dataclasses.field(default_factory=dict)
    assigned: Set[str] = dataclasses.field(default_factory=set)  # incl. ctor


def _parse_class(node: ast.ClassDef) -> _ClassInfo:
    info = _ClassInfo(name=node.name, lineno=node.lineno)
    for deco in node.decorator_list:
        if not isinstance(deco, ast.Call):
            continue
        name = _deco_call_name(deco)
        if name not in _DECOS:
            continue
        args = _str_args(deco)
        if name == "guarded_by" and len(args) >= 2:
            lock, attrs = args[0], args[1:]
            for a in attrs:
                info.guarded[a] = lock
        elif name == "shared_entry":
            for a in args:
                label, _, meth = a.rpartition(":")
                info.entries.append((label or meth, meth))
        elif name == "single_writer":
            info.single.extend(args)
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m = _scan_method(stmt)
            info.methods[m.name] = m
            info.assigned.update(w.path.split(".")[0] for w in m.writes)
    return info


def _roots(info: _ClassInfo) -> Dict[str, Set[str]]:
    """Map entry-point method name -> set of thread labels."""
    roots: Dict[str, Set[str]] = {}
    for label, meth in info.entries:
        roots.setdefault(meth, set()).add(label)
    for m in info.methods.values():
        if m.spawns:
            roots.setdefault(m.name, set()).add("main")
            for tgt in m.spawns:
                roots.setdefault(tgt, set()).add(f"thread:{tgt}")
    return roots


def _reachable_labels(info: _ClassInfo,
                      roots: Dict[str, Set[str]]) -> Dict[str, Set[str]]:
    """Thread labels under which each method may run (call-graph BFS)."""
    labels: Dict[str, Set[str]] = {}
    for root, root_labels in roots.items():
        if root not in info.methods:
            continue
        seen: Set[str] = set()
        frontier = [root]
        while frontier:
            name = frontier.pop()
            if name in seen or name not in info.methods:
                continue
            seen.add(name)
            labels.setdefault(name, set()).update(root_labels)
            frontier.extend(info.methods[name].calls)
    return labels


# ------------------------------------------------------------------ checking
def _check_class(info: _ClassInfo, filename: str) -> List[Finding]:
    findings: List[Finding] = []
    loc = lambda line: f"{filename}:{line}"  # noqa: E731

    roots = _roots(info)
    # LK403: declarations that cannot hold.
    for lock in sorted(set(info.guarded.values())):
        if lock not in info.assigned:
            findings.append(Finding(
                rule="LK403", severity="error", location=loc(info.lineno),
                message=(f"{info.name}: @guarded_by names lock {lock!r}, "
                         f"but the class never assigns self.{lock}"),
                hint="create the lock in __init__ or fix the declaration"))
    for _, meth in info.entries:
        if meth not in info.methods:
            findings.append(Finding(
                rule="LK403", severity="error", location=loc(info.lineno),
                message=(f"{info.name}: @shared_entry names {meth!r}, "
                         f"which is not a method of the class"),
                hint="fix the method name in the declaration"))

    labels = _reachable_labels(info, roots)

    # Gather reachable writes with their thread labels (ctors exempt).
    writes: List[Tuple[_Write, Set[str], str]] = []
    for name, m in info.methods.items():
        if name in _CTOR:
            continue
        mlabels = labels.get(name)
        if not mlabels:
            continue
        for w in m.writes:
            writes.append((w, mlabels, name))

    # Union of thread labels across all conflicting writes, per path.
    path_labels: Dict[str, Set[str]] = {}
    for w, mlabels, _ in writes:
        path_labels.setdefault(w.path, set()).update(mlabels)

    def conflict_labels(path: str) -> Set[str]:
        out: Set[str] = set()
        for q, ls in path_labels.items():
            if _conflicts(q, path):
                out.update(ls)
        return out

    def guard_for(path: str) -> Optional[str]:
        for decl, lock in info.guarded.items():
            if _conflicts(path, decl):
                return lock
        return None

    def is_single(path: str) -> bool:
        return any(_conflicts(path, s) for s in info.single)

    flagged: Set[Tuple[str, str]] = set()  # (rule, path) dedup
    for w, _, meth in writes:
        lock = guard_for(w.path)
        if lock is not None:
            if lock not in w.locks:
                findings.append(Finding(
                    rule="LK402", severity="error", location=loc(w.lineno),
                    message=(f"{info.name}.{meth}: writes self.{w.path} "
                             f"(declared guarded by {lock!r}) without "
                             f"holding the lock"),
                    hint=f"wrap the write in `with self.{lock}:`"))
            continue
        racy = len(conflict_labels(w.path)) >= 2
        if not racy:
            continue
        if is_single(w.path):
            key = ("LK404", w.path)
            if key not in flagged:
                flagged.add(key)
                findings.append(Finding(
                    rule="LK404", severity="error", location=loc(w.lineno),
                    message=(f"{info.name}: self.{w.path} is declared "
                             f"@single_writer but is written from multiple "
                             f"thread entry points "
                             f"({', '.join(sorted(conflict_labels(w.path)))})"),
                    hint="guard it with a lock and declare @guarded_by"))
        else:
            key = ("LK401", w.path)
            if key not in flagged:
                flagged.add(key)
                findings.append(Finding(
                    rule="LK401", severity="error", location=loc(w.lineno),
                    message=(f"{info.name}: self.{w.path} is written from "
                             f"multiple thread entry points "
                             f"({', '.join(sorted(conflict_labels(w.path)))}) "
                             f"with no guarded_by/single_writer declaration"),
                    hint=("declare @guarded_by(<lock>, ...) and hold the "
                          "lock, or @single_writer if one thread owns it")))
    return findings


# ------------------------------------------------------------------- entries
def check_source(src: str, filename: str = "<memory>") -> List[Finding]:
    """Audit one module's source text; returns LK4xx findings."""
    tree = ast.parse(src, filename=filename)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_check_class(_parse_class(node), filename))
    return findings


def check_file(path) -> List[Finding]:
    p = Path(path)
    return check_source(p.read_text(), filename=p.name)


def audit_default(root=None,
                  files: Sequence[str] = DEFAULT_FILES) -> List[Finding]:
    """Audit the pipeline's thread-owning modules (the CI surface)."""
    base = Path(root) if root is not None else Path(__file__).resolve().parents[1]
    findings: List[Finding] = []
    for rel in files:
        findings.extend(check_file(base / rel))
    return findings
