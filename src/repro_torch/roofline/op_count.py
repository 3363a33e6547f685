"""A dispatch-level cost counter: the port's stand-in for the
reference's ``roofline.hlo_parse``.

The reference lowers a step through XLA and parses the optimised HLO
text, because ``cost_analysis`` counts a loop body once.  Eager PyTorch
builds no HLO and no module to parse: each aten op runs as it is called,
so the op stream itself is the program.  :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten op of a step (autograd's
backward ops included) and adds, by ``hlo_parse``'s rules:

* FLOPs: matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``,
  ``mv``; einsums reach dispatch as these) at 2·M·N·K, also kept apart as
  ``matmul_flops``, and the other products ``FlopCounterMode`` knows
  (convolutions, fused attention) by its formulas; elementwise ops at 1
  an output element; reductions at their operand's elements (softmax as
  its two reductions and three elementwise passes); gathers at their
  result; views, allocations and metadata at 0, constants at 0.
* HBM bytes: operands plus results, a broadcast operand at its distinct
  elements; a gather or slice copy reads only the sliced bytes (its
  result); ``index_put_`` / ``scatter`` / ``index_add_`` count twice the
  indices and updates, and ``copy_`` into a view (an in-place slice
  write) the source and the view; views count 0.  Eager PyTorch fuses
  nothing, so this is what the eager step moves: there is no
  ``hbm_bytes_fused``.

The hand-written kernels are opaque to dispatch.  Their wrappers in
``kernels/ops.py`` are :func:`counted`: under an active counter a call
records one launch with the kernel's work model (``roofline/work.py``)
and silences the aten ops inside (a plain version's on the CPU, an
output allocation on ``meta``), so the CPU, the card and ``meta`` count
one way.  With no counter in force (every serve) a wrapper reads one
thread-local and calls straight through.

On ``meta`` nothing is allocated or computed: a full-width step counts in
seconds.  Collectives are opaque to dispatch too: the training step's
(``sharding.rules``' ``all_gather_dim``, ``reduce_scatter_dim`` and
``all_reduce``, which move nothing on ``meta``) each record their kind and
result bytes (:meth:`OpCounter.add_collective`), as ``analyze_hlo`` sums
a collective's result shape, and their calls a kind
(``collective_calls``).  One device has no collective and no loop to
unroll, so ``collectives`` is ``{}`` and ``unknown_trip_loops`` 0, as
``analyze_hlo`` gives them for such a module.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_MATMUL = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.dot, aten.vdot,
           aten.mv, aten.addmv}
_REDUCE = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
           aten.argmax, aten.argmin, aten.prod, aten.var, aten.var_mean,
           aten.std, aten.std_mean, aten.linalg_vector_norm, aten.norm,
           aten.logsumexp, aten.any, aten.all, aten.cumsum, aten.cumprod,
           aten.nansum}
_SOFTMAX = {aten._softmax, aten._log_softmax}
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding,
           aten.take}
_SCATTER = {aten.index_put_, aten.index_put, aten._index_put_impl_,
            aten.scatter, aten.scatter_, aten.scatter_add,
            aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
            aten.index_add, aten.index_add_, aten.index_copy,
            aten.index_copy_}
_COPY = {aten.copy_, aten._to_copy, aten.clone}
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh,
         aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
         aten.resize_, aten.set_, aten.record_stream, aten._unsafe_view,
         aten._reshape_alias}
# the innermost OpCounter in force on this thread (``counter``), kept by
# OpCounter.__enter__ / __exit__
_STATE = threading.local()

_CONSTANT = {aten.zeros, aten.ones, aten.full, aten.zeros_like,
             aten.ones_like, aten.full_like, aten.new_zeros, aten.new_ones,
             aten.new_full, aten.fill_, aten.zero_, aten.arange,
             aten.scalar_tensor, aten.lift_fresh_copy}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor reads: a broadcast (stride
    0) axis reads its element once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _matmul_flops(packet, args, out) -> int:
    """2·M·N·K from the result's elements and the contracted length."""
    if packet in (aten.dot, aten.vdot):
        return 2 * args[0].numel()
    a = args[1] if packet in (aten.addmm, aten.baddbmm, aten.addmv) \
        else args[0]
    return 2 * out.numel() * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs and HBM bytes of every aten op and hand-written
    kernel run under it (``with OpCounter() as c: step(...)``;
    :meth:`stats` gives the record)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.hbm_bytes = 0
        self.aten_ops = 0
        self.kernels = {}
        self.by_op = {}
        self.collectives = {}
        self.collective_calls = {}
        self._quiet = 0
        self._outer = None

    def __enter__(self):
        self._outer = active()
        _STATE.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _STATE.counter = self._outer
        self._outer = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if packet in _FREE or getattr(func, "is_view", False):
            return
        outs = _tensors(out)
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        out_elems = sum(t.numel() for t in outs)
        self.aten_ops += 1
        if packet in _CONSTANT:
            flops, nbytes = 0, out_bytes
            self._add(packet, flops, nbytes)
            return
        ins = _tensors((args, kwargs))
        if packet in _GATHER:
            flops, nbytes = out_elems, out_bytes
        elif packet in _SCATTER:
            upd = ins[1:]
            flops = ins[-1].numel()
            nbytes = 2 * sum(_distinct_bytes(t) for t in upd)
        elif packet in _COPY:
            src = args[1] if packet is aten.copy_ else args[0]
            dst = outs[0]
            flops = out_elems if src.dtype != dst.dtype else 0
            nbytes = _distinct_bytes(src) + dst.numel() * dst.element_size()
        else:
            nbytes = sum(_distinct_bytes(t) for t in ins) + out_bytes
            if packet in _MATMUL:
                mm = _matmul_flops(packet, args, outs[0])
                self.matmul_flops += mm
                # a fused bias add is an elementwise op of its own in HLO
                flops = mm + (out_elems if packet in (
                    aten.addmm, aten.baddbmm, aten.addmv) else 0)
            elif packet in flop_registry:
                mm = flop_registry[packet](*args, **kwargs, out_val=out)
                self.matmul_flops += mm
                flops = mm
            elif packet in _REDUCE:
                flops = ins[0].numel()
            elif packet in _SOFTMAX:
                flops = 5 * ins[0].numel()
            else:
                flops = out_elems
        self._add(packet, flops, nbytes)

    def _add(self, packet, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        row = self.by_op.setdefault(str(packet), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes

    def add_collective(self, kind: str, nbytes: int) -> None:
        """One collective of ``kind`` ("all-gather", "reduce-scatter",
        "all-reduce") whose result holds ``nbytes``."""
        self.collectives[kind] = self.collectives.get(kind, 0) + nbytes
        self.collective_calls[kind] = self.collective_calls.get(kind, 0) + 1

    def stats(self) -> dict:
        """``analyze_hlo``'s keys (``flops``, ``hbm_bytes``,
        ``collectives``, ``unknown_trip_loops``), plus ``matmul_flops``,
        ``aten_ops`` (aten ops dispatched, views and allocations not
        counted), ``kernels`` (launches, FLOPs and bytes a kernel) and
        ``collective_calls`` (calls a collective kind)."""
        return {"flops": float(self.flops),
                "hbm_bytes": float(self.hbm_bytes),
                "collectives": {k: float(v)
                                for k, v in self.collectives.items()},
                "collective_calls": dict(self.collective_calls),
                "unknown_trip_loops": 0,
                "matmul_flops": float(self.matmul_flops),
                "aten_ops": self.aten_ops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "by_op": {k: list(v) for k, v in self.by_op.items()}}


def active() -> Optional[OpCounter]:
    """The innermost :class:`OpCounter` in force on this thread, or None."""
    return getattr(_STATE, "counter", None)


def counted(name, work):
    """Decorator of a kernel wrapper.  Under an active counter a call
    records one launch of ``name`` (a string, or a function of the call's
    arguments giving one) with ``work(*args, **kwargs)``, the kernel's
    :class:`work.Work` (computed first, so its own ops are not counted),
    and silences the aten ops of the wrapper's body; with none in force
    the call goes straight through."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = active()
            if counter is None:
                return fn(*args, **kwargs)
            label = name if isinstance(name, str) else name(*args, **kwargs)
            counter._quiet += 1
            try:
                w = work(*args, **kwargs)
                counter.add_kernel(label, w.flops, w.nbytes)
                return fn(*args, **kwargs)
            finally:
                counter._quiet -= 1
        return call
    return wrap
