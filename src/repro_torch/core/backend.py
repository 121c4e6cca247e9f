"""Backend dispatch for the read hot path (edge enumeration, index probes,
per-hop compaction).

Port of ``repro/core/backend.py``: the seam between the semantics layer
(``core/edges.py``, ``core/index.py``, ``core/query/planner.py``) and the
hand-written kernels under ``repro_torch.kernels``.

  * ``kind="ref"``    — the JAX package's reference path in plain PyTorch
    (library sorts and searches, the direct dense edge expansion).  Defines
    the semantics.
  * ``kind="kernel"`` — the kernel path (tile plan -> ``edge_expand`` ->
    scatter, ``sorted_lookup``, ``dedup_compact``).  On CUDA tensors every
    kernel wrapper launches its CUDA kernel or raises; on CPU tensors it runs
    that kernel's plain PyTorch version, as Pallas runs in interpret mode on
    a CPU, so the CPU tests cover the tile plans and scatters too.

Selection: an explicit ``backend=`` argument, else ``$REPRO_BACKEND``
(``ref``/``kernel``/``auto``), else ``auto``, which is ``kernel``.  There is
no fallback from one kind to the other: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch.kernels.dedup_compact import kernel as _dedup_kernel
from repro_torch.kernels.dedup_compact import ref as _dedup_ref
from repro_torch.kernels.edge_expand import kernel as _expand_kernel
from repro_torch.kernels.edge_expand import ref as _expand_ref
from repro_torch.kernels.sorted_lookup import kernel as _lookup_kernel

_VALID = ("ref", "kernel", "auto")
ENV_VAR = "REPRO_BACKEND"


@dataclasses.dataclass(frozen=True)
class Backend:
    """Resolved backend choice.  Frozen: usable in program cache keys."""

    kind: str                 # 'ref' | 'kernel'

    @property
    def is_kernel(self) -> bool:
        return self.kind == "kernel"


REF = Backend("ref")
KERNEL = Backend("kernel")


def resolve(spec: Optional[str] = None) -> Backend:
    """Resolve a backend name (or None: ``$REPRO_BACKEND``, then ``auto``)."""
    name = spec or os.environ.get(ENV_VAR, "") or "auto"
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    return REF if name == "ref" else KERNEL


# ---------------------------------------------------------------------------
# dispatched primitives
# ---------------------------------------------------------------------------

def expand_tiles(starts, degs, pools, *, tile: int, cap_tiles: int):
    """Tile-padded ragged CSR span gather (kernel path only: the reference
    path expands densely).

    Returns (outs, item_of_tile, tw_of_tile, n_tiles): ``outs[i]`` is
    ``pools[i]`` gathered to (cap_tiles*tile,) with -1 in invalid lanes;
    lane j of tile t is edge ``tw_of_tile[t]*tile + j`` of frontier item
    ``item_of_tile[t]`` (item == F marks a padding tile)."""
    item, tw, n_tiles, _ = _expand_ref.plan(degs, tile, cap_tiles)
    outs = _expand_kernel.expand(starts, degs, tuple(pools), item, tw,
                                 tile=tile, cap_tiles=cap_tiles)
    return outs, item, tw, n_tiles


def searchsorted_blocked(keys, queries, lo, *, block: int, backend: Backend):
    """Left insertion position of each query within its own sorted block.

    ``keys`` is a flat block-major array whose slice ``[lo[q], lo[q]+block)``
    is sorted for every query q (``lo`` a multiple of ``block``).  Returns
    block-relative positions."""
    if backend.is_kernel:
        return _lookup_kernel.searchsorted_left_ranged(keys, queries, lo,
                                                       lo + block)
    # reference: binary search of every block, then each query's own block
    S = keys.shape[0] // block
    pos = torch.searchsorted(keys.view(S, block),
                             queries[None, :].expand(S, -1).contiguous(),
                             out_int32=True)
    return pos.gather(0, (lo // block).long()[None, :])[0]


def sort_rows(x, *, backend: Backend):
    """Row-wise ascending sort of an (R, W) i32 matrix."""
    if backend.is_kernel:
        return _dedup_kernel.sort_rows(x)
    return _dedup_ref.sort_rows(x)


def dedup_compact_rows(x, cap: int, *, backend: Backend):
    """(R, W) candidates (PAD = invalid) -> ((R, cap) sorted-unique regions,
    (R,) unique counts).  The §3.4 per-hop compaction; counts > cap is the
    fast-fail condition."""
    if backend.is_kernel:
        return _dedup_kernel.dedup_compact_rows(x, cap)
    return _dedup_ref.dedup_compact_rows(x, cap)
