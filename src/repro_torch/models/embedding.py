"""Embedding-table lookups: the plain row gather and A1-style query
shipping over a shard mesh.

Port of ``repro/models/embedding.py``:

  * :func:`gspmd_lookup` — a plain row gather, padding ids (< 0) giving
    zero rows (on one device the table is one tensor);
  * :func:`a1_ship_lookup` — the paper's §3.4 protocol over a
    ``dist/mesh.py::ShardMesh``: the table's rows split into S contiguous
    blocks, every shard serves the ids it owns from its block, and a psum
    combines the shards' rows (each id has one owner).  Written in
    lockstep, as the mesh's SPMD programs are: a loop over the shards and
    one collective on the list.
"""
from __future__ import annotations

import torch

from repro_torch.dist.mesh import psum


def gspmd_lookup(table, ids):
    """table (V, D), ids (...) -> (..., D); ids < 0 give zero rows."""
    ok = ids >= 0
    safe = ids.clamp(min=0).long()
    return table[safe] * ok[..., None].to(table.dtype)


def _ship_lookup_local(table_local, ids, me: int, S: int):
    """Shard ``me``'s part: the rows of the ids it owns (owner = id //
    rows_per, the contiguous block split), zero rows for the others."""
    rows_per = table_local.shape[0]
    ok = ids >= 0
    owner = torch.where(ok, torch.div(ids, rows_per, rounding_mode="floor"),
                        S)
    mine = owner == me
    rows = torch.where(mine, ids % rows_per, 0).long()
    return table_local[rows] * mine[:, None].to(table_local.dtype)


def a1_ship_lookup(table, ids, mesh):
    """Query-shipping lookup over ``mesh``: table (V, D), V a multiple of
    the mesh's S shards (shard s holds rows [s V/S, (s+1) V/S)); ids (...)
    replicated.  Returns the (..., D) rows, replicated: one tensor a shard,
    on its device, each equal to :func:`gspmd_lookup`."""
    S = mesh.size
    V, D = table.shape
    if V % S:
        raise ValueError(f"{V} table rows do not split over {S} shards")
    blocks = table.view(S, V // S, D)
    flat = ids.reshape(-1)
    vals = [_ship_lookup_local(blocks[s].to(dev), flat.to(dev), s, S)
            for s, dev in enumerate(mesh.devices)]
    return [v.reshape(*ids.shape, D) for v in psum(vals)]
