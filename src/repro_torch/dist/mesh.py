"""The shard mesh: one controller driving S storage shards in lockstep.

The JAX package runs its SPMD query programs as one controller over S
devices (``shard_map`` over the ``("data", "model")`` axes): the store's
leading axis is split into S contiguous blocks, and ``axis_index`` over the
two axes is row-major.  The port keeps that model in one process:

  * :class:`ShardMesh` is an ordered list of S torch devices, one per shard
    (a device may repeat: ``make_mesh(4, device="cuda")`` holds four shards
    side by side on one card).  A shard's position in the list is its
    ``axis_index``, the row-major order of JAX's ``("data", "model")``;
  * :func:`shard_store` gives every shard its block of every
    ``GraphStore`` field (the ``in_specs`` split), as views where the
    shard's device is the store's;
  * every collective takes the list of per-shard tensors and returns a
    list, with ``jax.lax``'s semantics: :func:`all_to_all` (tiled, split and
    concat on axis 0), :func:`psum` (summed in shard order, replicated) and
    :func:`all_gather` (stacked on a new axis 0).

An SPMD program is written in lockstep: every per-shard step is a loop over
the mesh's shards, each on its own device, and every collective is one call
on the whole list, so the programs read like the ``shard_map`` bodies they
port.  The JAX package has no multi-process runtime either: its SPMD
serving is one controller over the mesh, as here.  The query programs,
``models/embedding.py::a1_ship_lookup`` and
``optim/compression.py::ef_compress_grads(axis_name=)`` run on it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.addressing import StoreConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.store import FIELDS, GraphStore


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """S shards, shard s on ``devices[s]``.  Frozen: usable in program
    cache keys."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def replicate(self, t: torch.Tensor) -> list:
        """``t`` on every shard's device (the ``P()`` in-spec): the same
        tensor where the device is ``t``'s, a copy elsewhere."""
        return [t.to(d) for d in self.devices]


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
    blocks = [x.reshape(S, -1, *x.shape[1:]) for x in xs]
    return [torch.cat([b[d].to(xs[d].device) for b in blocks])
            .reshape(-1, *xs[d].shape[1:]) for d in range(S)]


def psum(xs: list) -> list:
    """``jax.lax.psum``: the sum over shards, in shard order, on every
    shard's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return [total.to(x.device) for x in xs]


def all_gather(xs: list) -> list:
    """``jax.lax.all_gather``: the shards' tensors stacked on a new axis 0,
    on every shard's device."""
    stacked = torch.stack([x.to(xs[0].device) for x in xs])
    return [stacked.to(x.device) for x in xs]
