"""The work of one kernel call, as each kernel's ``cost`` gives it.

A :class:`Cost` is what the card must do for a call, whatever the kernel's
design: the operations it counts (``flops``, on the units ``unit`` names:
``"bf16"`` the tensor cores, ``"f32"`` the CUDA cores outside them), the
exponentials on the special-function units (``exps``), and the bytes that
must cross HBM (each input read once, each output written once). It also
carries ``launches``, the device launches the call makes. Costs of one unit
add; ``n * cost`` is ``n`` calls. ``launch/roofline.py::bound`` turns a
cost into the least time of the call on the H100.

Where the work depends on the data (the decode kernels' lengths, the
grouped product's routing), a kernel's ``cost`` takes the data's figures
when the caller has them and counts the whole buffer when it has not (a
meta pass, which has no values), as XLA's cost analysis does.

On a meta tensor (the dry-run's pass, ``launch/counter.py``) each wrapper
runs as on the card, with its checks and allocations, up to its launch;
there it hands the call's cost to :func:`record` in place of the launch,
and counts no launch. The recorders a scope installs (:func:`recording`)
receive it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

UNITS = ("bf16", "f32")


@dataclass(frozen=True)
class Cost:
    flops: int = 0
    bytes: int = 0
    exps: int = 0
    unit: str = "f32"
    launches: int = 1

    def __post_init__(self):
        if self.unit not in UNITS:
            raise ValueError(f"cost unit {self.unit!r}: expected one of "
                             f"{UNITS}")

    def __add__(self, other: "Cost") -> "Cost":
        if other.unit != self.unit:
            raise ValueError(f"adding a {other.unit} cost to a {self.unit} "
                             f"one")
        return Cost(self.flops + other.flops, self.bytes + other.bytes,
                    self.exps + other.exps, self.unit,
                    self.launches + other.launches)

    def __rmul__(self, n: int) -> "Cost":
        return Cost(n * self.flops, n * self.bytes, n * self.exps, self.unit,
                    n * self.launches)


# recorders of meta calls: ``sink(name, cost)``; a plain list, not a
# thread-local, since autograd may run a backward on a thread of its own
_sinks: list[Callable[[str, Cost], None]] = []
_grad_sinks: list[Callable[[str], None]] = []


@contextlib.contextmanager
def recording(sink: Callable[[str, Cost], None],
              grad_sink: Callable[[str], None] | None = None):
    """Hand every meta kernel call's ``(name, cost)`` to ``sink`` for the
    scope, and each backward a meta call will need (:func:`note_grad`) to
    ``grad_sink``."""
    _sinks.append(sink)
    if grad_sink is not None:
        _grad_sinks.append(grad_sink)
    try:
        yield
    finally:
        _sinks.remove(sink)
        if grad_sink is not None:
            _grad_sinks.remove(grad_sink)


def record(name: str, cost: Cost) -> None:
    """A wrapper's call on meta tensors: its cost, in place of a launch."""
    for sink in list(_sinks):
        sink(name, cost)


def note_grad(name: str) -> None:
    """A meta forward call that needs a gradient: its backward ``name``
    (the tally ``ops.plain_calls`` keeps for a plain call)."""
    for sink in list(_grad_sinks):
        sink(name)
