"""Op counts of one step: flops, bytes moved, wire bytes and peak memory.

Port of ``repro/launch/hloanalysis.py``.  The JAX module re-derives loop-
aware totals from XLA's optimized HLO text.  A PyTorch step has no HLO, so
its counterpart, :func:`analyze_ops`, runs the step once on ``meta``
tensors (shapes and dtypes, no storage and no arithmetic) under a
``TorchDispatchMode`` and counts what it dispatches.  The trace runs every
loop, so there are no trip counts to recover.  Into the same
:class:`Analysis` fields:

  * ``flops``: 2 x output elements x contracted size for every ``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, ``mv`` and ``dot`` (the matmuls an
    ``einsum`` or ``matmul`` lowers to), the backward's and each
    checkpoint's recompute included (``matmul_flops``, the subtotal; the
    recompute reruns the whole block, as it does outside a dispatch mode,
    where PyTorch's early stop does not cut it short), plus
    what each hand-written kernel's meta route reports for its call
    (``kernel_flops``; ``kernels/_cuda.py::count_kernel``); the same flops
    by the dtype whose peak they run at (``flops_by_dtype``: a matmul's
    operands', a kernel's own), which the roofline charges dtype by dtype;
  * ``mem_bytes``: the input plus output bytes of every dispatched op that
    moves data (views and allocations move none), plus the kernels'
    reported bytes; like JAX's model, every op reads and writes memory
    (PyTorch's eager ops are its fusion boundaries);
  * ``wire_bytes`` and ``coll_detail``: the lockstep collectives
    (``dist/mesh.py``) charged by JAX's ring model
    (``launch/roofline.py::collective_wire_bytes``);
  * ``peak_bytes``: the most bytes of ``meta`` storage alive at once,
    arguments included.  Storages are tracked by weak references: a
    tensor's death marks its storage to check, and a storage that
    something else still holds (autograd's saved outputs) is checked again
    every few ops, so a free may be seen a few ops late.

A value the step reads back to the host (``bool(torch.isfinite(loss))``)
has no data on ``meta``: it reads as true, or 1, and ``host_reads`` counts
it.  A step whose control flow depends on such reads (the A1 query waves)
cannot be traced, and the dry run records it as host-driven instead.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _cuda
from repro_torch.launch.roofline import collective_wire_bytes

_MATMULS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1, "mv": 0, "dot": 0}
# ops that move no data: allocations and reshapes of contiguous storage
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "_local_scalar_dense"}
_RECHECK = 16       # ops between checks of storages held outside Python


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0                       # matmuls + kernels
    wire_bytes: float = 0.0                  # collective wire traffic
    mem_bytes: float = 0.0                   # bytes the ops move
    coll_detail: dict = dataclasses.field(default_factory=dict)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    matmul_flops: float = 0.0
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    arg_bytes: int = 0
    out_bytes: int = 0
    alias_bytes: int = 0                     # outputs in argument storage
    n_ops: int = 0
    host_reads: int = 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _key(t) -> int:
    return t.untyped_storage()._cdata


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.res = Analysis()
        self.kernel_bytes = 0.0
        self.colls: list = []
        self.live: dict = {}          # storage key -> (weak ref, bytes)
        self.live_bytes = 0
        self.dead: set = set()        # keys whose tensors died
        self.linger: set = set()      # keys still held outside Python
        self.since = 0

    # ---- storage tracking -------------------------------------------------
    def track(self, t) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        k = st._cdata
        ref = self.live.get(k)
        if ref is None or ref[0].expired():
            if ref is not None:
                self.live_bytes -= ref[1]
            self.live[k] = (StorageWeakRef(st), st.nbytes())
            self.live_bytes += st.nbytes()
        weakref.finalize(t, self._died, k)

    def _died(self, k) -> None:
        self.dead.add(k)

    def _sweep(self, keys) -> set:
        held = set()
        for k in keys:
            ref = self.live.get(k)
            if ref is None:
                continue
            if ref[0].expired():
                del self.live[k]
                self.live_bytes -= ref[1]
            else:
                held.add(k)
        return held

    def collect(self) -> None:
        if self.dead:
            dead, self.dead = self.dead, set()
            self.linger |= self._sweep(dead)
        self.since += 1
        if self.since >= _RECHECK:
            self.since = 0
            self.linger = self._sweep(self.linger)

    # ---- what kernels and collectives report ------------------------------
    def kernel(self, name: str, flops: float, nbytes: float,
               dtype: torch.dtype) -> None:
        r = self.res
        r.kernel_flops[name] = r.kernel_flops.get(name, 0.0) + flops
        self.add_flops(dtype, flops)
        r.kernel_calls[name] = r.kernel_calls.get(name, 0) + 1
        self.kernel_bytes += nbytes

    def collective(self, kind: str, nbytes: int, group: int) -> None:
        self.colls.append((kind, nbytes, group))

    def add_flops(self, dtype: torch.dtype, flops: float) -> None:
        key = str(dtype).replace("torch.", "")
        by = self.res.flops_by_dtype
        by[key] = by.get(key, 0.0) + flops

    # ---- every dispatched op ----------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.collect()          # the frees since the last op, first
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense" and args[0].device.type == "meta":
            self.res.host_reads += 1
            x = args[0]
            return True if x.dtype == torch.bool else \
                (1.0 if x.is_floating_point() else 1)
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.device.type == "meta" for t in ins + outs):
            return out
        r = self.res
        r.n_ops += 1
        if name in _MATMULS:
            a = args[_MATMULS[name]]
            flops = 2.0 * outs[0].numel() * a.shape[-1]
            r.matmul_flops += flops
            self.add_flops(a.dtype, flops)
        if not (func.is_view or name in _NO_TRAFFIC):
            r.mem_bytes += sum(t.numel() * t.element_size()
                               for t in ins + outs)
        for t in outs:
            self.track(t)
        r.peak_bytes = max(r.peak_bytes, self.live_bytes)
        return out


def analyze_ops(fn, *args, n_devices: int = 1, **kwargs):
    """Run ``fn(*args, **kwargs)`` once on its ``meta`` arguments and count
    its ops.  Returns (Analysis, fn's result)."""
    c = _Counter()
    arg_ts = _tensors((args, kwargs))
    for t in arg_ts:
        c.track(t)
    arg_keys = {_key(t) for t in arg_ts if t.device.type == "meta"}
    c.res.arg_bytes = c.live_bytes
    c.res.peak_bytes = c.live_bytes
    _cuda.COUNTERS.append(c)
    try:
        # under a dispatch mode a checkpoint's recompute stops once it has
        # what the backward saved; outside one it reruns the whole block
        with set_checkpoint_early_stop(False), c:
            out = fn(*args, **kwargs)
    finally:
        _cuda.COUNTERS.pop()
    r = c.res
    seen = {}
    for t in _tensors(out):
        if t.device.type == "meta":
            seen[_key(t)] = t.untyped_storage().nbytes()
    r.out_bytes = sum(seen.values())
    r.alias_bytes = sum(b for k, b in seen.items() if k in arg_keys)
    r.flops = r.matmul_flops + sum(r.kernel_flops.values())
    r.mem_bytes += c.kernel_bytes
    coll = collective_wire_bytes(c.colls, n_devices)
    r.wire_bytes = coll.pop("total")
    r.coll_detail = coll
    return r, out
