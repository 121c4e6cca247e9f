"""The shard mesh: one controller driving S storage shards in lockstep.

The JAX package runs its SPMD query programs as one controller over S
devices (``shard_map`` over the ``("data", "model")`` axes): the store's
leading axis is split into S contiguous blocks, and ``axis_index`` over the
two axes is row-major.  The port keeps that model in one process:

  * :class:`ShardMesh` is an ordered list of S torch devices, one per shard
    (a device may repeat: ``make_mesh(4, device="cuda")`` holds four shards
    side by side on one card), laid out over named axes, ``("data",
    "model")`` of shape ``(1, S)`` unless the caller names others.  A
    shard's position in the list is its row-major index over the axes, as
    ``axis_index`` over all of JAX's mesh axes is; :func:`axis_index` gives
    its index along one axis.  ``with mesh:`` puts the mesh in scope on a
    thread-local stack (:func:`current`), as JAX's ``with mesh:`` does;
  * :func:`shard_store` gives every shard its block of every
    ``GraphStore`` field (the ``in_specs`` split), as views where the
    shard's device is the store's;
  * every collective takes the list of per-shard tensors and returns a
    list, with ``jax.lax``'s semantics: :func:`all_to_all` (tiled, split and
    concat on axis 0), :func:`psum` (summed in shard order, replicated,
    over the whole mesh or within each group of one named axis),
    :func:`all_gather` (stacked on a new axis 0) and :func:`ppermute`
    (pairs along one named axis).

An SPMD program is written in lockstep: every per-shard step is a loop over
the mesh's shards, each on its own device, and every collective is one call
on the whole list, so the programs read like the ``shard_map`` bodies they
port.  The JAX package has no multi-process runtime either: its SPMD
serving is one controller over the mesh, as here.  The query programs,
``models/embedding.py::a1_ship_lookup``,
``optim/compression.py::ef_compress_grads(axis_name=)``, the ring matmul
(``dist/overlap.py``) and the pipeline (``dist/pipeline.py``) run on it.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import torch

from repro_torch.core.addressing import StoreConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.store import FIELDS, GraphStore
from repro_torch.kernels import _cuda


class _Scope(threading.local):
    def __init__(self):
        self.stack: list = []


_SCOPE = _Scope()


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """S shards, shard s on ``devices[s]``, over the named axes
    ``axis_names`` of sizes ``shape`` (row-major; ``(1, S)`` over
    ``("data", "model")`` by default).  Frozen: usable in program cache
    keys.  ``with mesh:`` puts it in scope (:func:`current`)."""

    devices: tuple
    axis_names: tuple = ("data", "model")
    shape: tuple = None

    def __post_init__(self):
        if self.shape is None:
            object.__setattr__(
                self, "shape",
                (1,) * (len(self.axis_names) - 1) + (len(self.devices),))
        if len(self.shape) != len(self.axis_names) or \
                math.prod(self.shape) != len(self.devices):
            raise ValueError(f"a mesh of shape {self.shape} over axes "
                             f"{self.axis_names} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        """The size of the named axis (``mesh.shape[axis]`` in JAX)."""
        return self.shape[self.axis_names.index(axis)]

    def __enter__(self):
        _SCOPE.stack.append(self)
        return self

    def __exit__(self, *exc):
        _SCOPE.stack.pop()

    def replicate(self, t: torch.Tensor) -> list:
        """``t`` on every shard's device (the ``P()`` in-spec): the same
        tensor where the device is ``t``'s, a copy elsewhere."""
        return [t.to(d) for d in self.devices]


def current():
    """The innermost mesh in scope (``with mesh:``), else None."""
    return _SCOPE.stack[-1] if _SCOPE.stack else None


def make_mesh(n_shards: int, device=None) -> ShardMesh:
    """A mesh of ``n_shards`` shards side by side on one device (``cuda``
    unless the caller names another; raises without a GPU)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return ShardMesh((resolve_device(device),) * n_shards)


def shard_store(store: GraphStore, cfg: StoreConfig, mesh: ShardMesh):
    """Per-shard stores: field ``f`` of shard s is ``f.view(S, n/S, ...)[s]``,
    a view where shard s lives on the store's device and a copy elsewhere.
    Cached on the store object, keyed by the mesh and the fields' storage,
    so every query over one store splits it once."""
    S = mesh.size
    if S != cfg.n_shards:
        raise ValueError(f"a mesh of {S} shards over a store of "
                         f"{cfg.n_shards}")
    tensors = store.tensors()
    key = (mesh, tuple(t.data_ptr() for t in tensors))
    cache = store.__dict__.setdefault("_shard_views", {})
    if key not in cache:
        cache.clear()
        cache[key] = [GraphStore(**{
            name: t.view(S, t.shape[0] // S, *t.shape[1:])[s]
            .to(mesh.devices[s])
            for name, t in zip(FIELDS, tensors)}) for s in range(S)]
    return cache[key]


# ---------------------------------------------------------------------------
# collectives over per-shard lists
# ---------------------------------------------------------------------------

def all_to_all(xs: list) -> list:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``:
    every shard's axis 0 splits into S blocks, and shard d receives block d
    of every shard, concatenated in shard order."""
    S = len(xs)
    _cuda.count_collective("all-to-all", _nbytes(xs[0]), S)
    blocks = [x.reshape(S, -1, *x.shape[1:]) for x in xs]
    return [torch.cat([b[d].to(xs[d].device) for b in blocks])
            .reshape(-1, *xs[d].shape[1:]) for d in range(S)]


def _groups(mesh: ShardMesh, axis: str) -> list:
    """The shards of each group along ``axis`` (those that share every other
    axis's index), each group in order of its index along ``axis``."""
    a = mesh.axis_names.index(axis)
    shards = torch.arange(mesh.size).reshape(mesh.shape)
    return shards.movedim(a, -1).reshape(-1, mesh.shape[a]).tolist()


def axis_index(mesh: ShardMesh, axis: str) -> list:
    """``jax.lax.axis_index(axis)`` of every shard: its index along the
    named axis."""
    out = [0] * mesh.size
    for group in _groups(mesh, axis):
        for i, s in enumerate(group):
            out[s] = i
    return out


def psum(xs: list, axis=None, mesh=None) -> list:
    """``jax.lax.psum``: the sum over shards, in shard order, on every
    shard's device; with ``axis``, the sum within each group of shards
    along that axis of ``mesh`` (the mesh in scope by default)."""
    groups = [list(range(len(xs)))] if axis is None else \
        _groups(scoped(mesh), axis)
    _cuda.count_collective("all-reduce", _nbytes(xs[0]), len(groups[0]))
    out = [None] * len(xs)
    for group in groups:
        total = xs[group[0]]
        for s in group[1:]:
            total = total + xs[s].to(total.device)
        for s in group:
            out[s] = total.to(xs[s].device)
    return out


def ppermute(xs: list, mesh, axis: str, perm) -> list:
    """``jax.lax.ppermute(x, axis, perm)``: within each group of shards
    along ``axis``, the shard at index i sends its tensor to the one at
    index j for each pair (i, j) of ``perm``; a shard that receives nothing
    gets zeros."""
    mesh = scoped(mesh)
    _cuda.count_collective("collective-permute", _nbytes(xs[0]),
                           mesh.axis_size(axis))
    out = [None] * len(xs)
    for group in _groups(mesh, axis):
        for i, j in perm:
            out[group[j]] = xs[group[i]].to(xs[group[j]].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def scoped(mesh=None):
    """``mesh``, or the mesh in scope; raises without either."""
    mesh = current() if mesh is None else mesh
    if mesh is None:
        raise ValueError("a collective over a named axis needs a mesh: pass "
                         "mesh= or enter one with `with mesh:`")
    return mesh


def all_gather(xs: list) -> list:
    """``jax.lax.all_gather``: the shards' tensors stacked on a new axis 0,
    on every shard's device."""
    _cuda.count_collective("all-gather", len(xs) * _nbytes(xs[0]), len(xs))
    stacked = torch.stack([x.to(xs[0].device) for x in xs])
    return [stacked.to(x.device) for x in xs]
