"""The counter of a meta pass: a program's product FLOPs, kernel costs, HBM
bytes and peak live bytes, with nothing allocated and no card.

:class:`MetaCounter` is a ``TorchDispatchMode`` over a program that runs on
meta tensors (``launch/cells.py``). For every aten op it counts:

- the products' FLOPs (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions and their backward; ``einsum`` reaches these), by
  ``torch.utils.flop_counter``'s formulas (2 M N K a product), each on the
  units of its operands' type (bf16 on the tensor cores, f32 on the CUDA
  cores: ``launch/roofline.py``);
- the HBM bytes it moves: its tensor inputs read and its outputs written;
  a view moves none; a gather (``embedding``, ``index_select``, ``index``,
  ``gather``) reads only the rows it writes, a scatter into a tensor
  (``index_put_``, ``index_copy_``, ``scatter_``) writes only the rows it
  reads; each kernel's own bytes come from its cost, not from here;
- the peak of live bytes above the arguments (the counterpart of the
  reference's ``memory_analysis`` ``temp_size``): storages made during the
  pass, each counted once, however many views share it, from its first
  op to its release.

The kernels' wrappers, which on meta tensors record each call at its
launch (``kernels/_cost.py::record``), hand it each call's
:class:`~repro_torch.kernels._cost.Cost`: their calls, device launches,
FLOPs, exponentials and bytes. Under remat the recomputed forward runs
again, and counts again, as the reference's unrolled count does.
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels._cost import Cost, recording
from repro_torch.launch.roofline import RATES, ops_seconds

aten = torch.ops.aten

# ops that move no byte (besides views)
_NO_TRAFFIC = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.detach,
    aten.alias, aten.lift_fresh, aten._local_scalar_dense, aten.set_,
    aten.resize_, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size,
}
# reads of the rows they write: (the index argument's position)
_GATHERS = {aten.embedding: 1, aten.index_select: 2, aten.gather: 2,
            aten.index: 1}
# writes of the rows they read: (the values argument's position)
_SCATTERS = {aten.index_put_: 2, aten.index_put: 2,
             aten._index_put_impl_: 2, aten.index_copy_: 3,
             aten.index_copy: 3, aten.scatter_: 3, aten.scatter: 3,
             aten.scatter_add_: 3, aten.scatter_add: 3, aten.index_add_: 3,
             aten.index_add: 3}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class MetaCounter(TorchDispatchMode):
    """Counts a program's work (see the module's docstring). Read after the
    scope: ``flops`` (products and kernels), ``product_flops`` by unit,
    ``compute_s`` (each op's least time on its units, summed), ``bytes``,
    ``peak_bytes``, ``kernels`` (name -> calls, launches, flops, exps,
    bytes) and ``grad_calls`` (a kernel's backward name -> the forward
    calls that needed it, ``ops.plain_calls``' tally)."""

    def __init__(self):
        super().__init__()
        self.product_flops = {"bf16": 0, "f32": 0}
        self.kernel_flops = 0
        self.compute_s = 0.0
        self.bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self.kernels: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "launches": 0, "flops": 0, "exps": 0,
                     "bytes": 0})
        self.grad_calls: dict[str, int] = defaultdict(int)
        self._storages: set[int] = set()

    @property
    def flops(self) -> int:
        return sum(self.product_flops.values()) + self.kernel_flops

    # -- kernels -------------------------------------------------------------
    def _kernel(self, name: str, cost: Cost) -> None:
        k = self.kernels[name]
        k["calls"] += 1
        k["launches"] += cost.launches
        k["flops"] += cost.flops
        k["exps"] += cost.exps
        k["bytes"] += cost.bytes
        self.kernel_flops += cost.flops
        self.bytes += cost.bytes
        self.compute_s += ops_seconds(cost)

    def _grad(self, name: str) -> None:
        self.grad_calls[name] += 1

    def __enter__(self):
        self._rec = recording(self._kernel, self._grad)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(*exc)

    # -- liveness ------------------------------------------------------------
    def _release(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor, inputs: set[int]) -> None:
        """Count ``t``'s storage from now, unless counted already or one of
        the op's inputs' that the pass did not make (an argument's, written
        in place)."""
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages or key in inputs:
            return
        n = st.nbytes()
        self._storages.add(key)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._release, key, n)

    # -- ops -----------------------------------------------------------------
    def _traffic(self, func, packet, args, kwargs, out) -> int:
        if func.is_view or packet in _NO_TRAFFIC:
            return 0
        outs = _tensors(out)
        if packet in _GATHERS:
            idx = args[_GATHERS[packet]] if len(args) > _GATHERS[packet] \
                else None
            return 2 * sum(map(_nbytes, outs)) + sum(
                map(_nbytes, _tensors(idx)))
        if packet in _SCATTERS:
            pos = _SCATTERS[packet]
            vals = args[pos] if len(args) > pos else None
            rest = [t for i, a in enumerate(args) if i not in (0, pos)
                    for t in _tensors(a)]
            return 2 * sum(map(_nbytes, _tensors(vals))) + sum(
                map(_nbytes, rest))
        ins = {id(t): t for t in _tensors((args, kwargs))}
        return sum(map(_nbytes, ins.values())) + sum(map(_nbytes, outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            first = _tensors(args)[0]
            unit = "f32" if first.dtype == torch.float32 else "bf16"
            self.product_flops[unit] += flops
            self.compute_s += flops / RATES[unit]
        self.bytes += self._traffic(func, packet, args, kwargs, out)
        inputs = {t.untyped_storage()._cdata
                  for t in _tensors((args, kwargs))
                  if t.device.type == "meta"}
        for t in _tensors(out):
            self._track(t, inputs)
        return out

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "product_flops": dict(self.product_flops),
            "kernel_flops": self.kernel_flops,
            "compute_s": self.compute_s,
            "bytes": self.bytes,
            "peak_bytes": self.peak_bytes,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "grad_calls": dict(sorted(self.grad_calls.items())),
        }
