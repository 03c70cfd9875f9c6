"""Work accounting for the kernels' meta branches.

The kernels are launched through ``ctypes``, so no ``TorchDispatchMode``
sees them: a cost counter that watches aten ops would count a kernel's work
as zero. A wrapper given a tensor on the ``meta`` device therefore returns
an empty output of the right shape and dtype and calls :func:`charge` with
the kernel's work from a formula of its shapes: its floating-point
operations (matrix-product FLOPs, the rule of XLA's ``dot``; integer
hashing counts none) and the bytes it must move (each input read once,
each output written once). :func:`counting` fills the one slot (a
context variable) that holds the sink receiving the charges; with the slot
empty a charge is dropped. :func:`repro_torch.launch.hlo_stats.step_cost`
is its one owner, and a second sink while one is active is refused.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional

Sink = Callable[[str, float, float], None]   # (kernel, flops, bytes)

_sink: contextvars.ContextVar[Optional[Sink]] = contextvars.ContextVar("cost_sink", default=None)


@contextlib.contextmanager
def counting(sink: Sink) -> Iterator[None]:
    """Send the charges of this thread's meta-branch calls to ``sink``
    while the block runs."""
    if _sink.get() is not None:
        raise RuntimeError("a cost sink is already active")
    token = _sink.set(sink)
    try:
        yield
    finally:
        _sink.reset(token)


def charge(kernel: str, *, flops: float, nbytes: float) -> None:
    """Charge one kernel call's work to this thread's sink, if one is set."""
    sink = _sink.get()
    if sink is not None:
        sink(kernel, float(flops), float(nbytes))
