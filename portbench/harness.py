"""Pieces the kinds share: the feed from host batches, the set-up clock
and the result a kind hands back."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from portbench.devtrace import TraceSummary


class WindowClosed(Exception):
    """Raised by a batch source once the measured window has run out."""


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """Copies the host batches to the device one at a time, in order and
    round again, as the program asks for them (pinned host memory, so the
    copy is asynchronous on the current stream)."""

    def __init__(self, batches: List[Dict[str, torch.Tensor]], device):
        self.batches, self.device, self.next = batches, torch.device(device), 0

    def __call__(self, _step: int = 0) -> Dict[str, torch.Tensor]:
        host = self.batches[self.next % len(self.batches)]
        self.next += 1
        return {k: v.to(self.device, non_blocking=True) for k, v in host.items()}


class Stopwatch:
    """Set-up's parts: the seconds between marks (``parts``), and the
    seconds spent on the check's own bookkeeping, which ``setup_s`` leaves
    out (``excluded``)."""

    def __init__(self):
        self.excluded = 0.0
        self.parts: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = now - self._last
        self._last = now

    @contextlib.contextmanager
    def exclude(self):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.excluded += time.perf_counter() - t


@dataclasses.dataclass
class KindResult:
    setup_end: float                # perf_counter when set-up ended
    setup_parts: Dict[str, float]   # seconds of each part of set-up, for the log
    excluded_s: float               # check work inside set-up, not in setup_s
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]       # the check's numbers, by name
    window: Dict[str, float]        # units, seconds, rows a unit
    trace: Optional[TraceSummary] = None
    detail: str = ""                # the check's numbers in detail, for the log


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free_device(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
