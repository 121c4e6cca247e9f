"""Backend dispatch for the read hot path (edge enumeration, index probes,
per-hop compaction, the shared frontier's pair sort, the k-NN probe) and
for the transformer's RMSNorm and attention.

Port of ``repro/core/backend.py``: the seam between the semantics layer
(``core/edges.py``, ``core/index.py``, ``core/query/planner.py``) and the
hand-written kernels under ``repro_torch.kernels``.

  * ``kind="ref"``    — the JAX package's reference path in plain PyTorch
    (library sorts and searches, the direct dense edge expansion, the plain
    k-NN).  Defines the semantics.
  * ``kind="kernel"`` — the kernel path (tile plan -> ``edge_expand`` ->
    scatter, both ``sorted_lookup`` probes, ``dedup_compact``, ``sort_pairs``,
    ``knn_topk``; the model's ``rmsnorm_fwd`` and ``flash_fwd``).  On CUDA
    tensors every
    kernel wrapper launches its CUDA kernel or raises; on CPU tensors it runs
    that kernel's plain PyTorch version, as Pallas runs in interpret mode on
    a CPU, so the CPU tests cover the tile plans and scatters too.

``models/attention.py::mha`` takes the same kinds (the ``ref`` kind there is
the JAX package's chunked recurrence).

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
from repro_torch.kernels.knn_topk import kernel as _knn_kernel
from repro_torch.kernels.knn_topk import ref as _knn_ref
from repro_torch.kernels.rmsnorm import ops as _rms_ops
from repro_torch.kernels.rmsnorm import ref as _rms_ref
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
DEDUP_MAX_W = _dedup_kernel.MAX_W     # the widest row the dedup kernel takes


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means ``cuda``, which raises
    when no GPU is present (an entry point never carries on quietly on the
    CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the port's entry points default to "
                               "device='cuda' and no CUDA device is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve(spec: Optional[str] = None) -> Backend:
    """Resolve a backend name (or None: ``$REPRO_BACKEND``, then ``auto``);
    a resolved :class:`Backend` is returned as it is."""
    if isinstance(spec, Backend):
        return spec
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
                                                       width=block)
    # reference: binary search of every block, then each query's own block
    S = keys.shape[0] // block
    pos = torch.searchsorted(keys.view(S, block),
                             queries[None, :].expand(S, -1).contiguous(),
                             out_int32=True)
    return pos.gather(0, (lo // block).long()[None, :])[0]


def searchsorted(keys, queries, *, backend: Backend):
    """Left insertion position of each query in one flat sorted array (a
    shard's whole index block in the SPMD probe)."""
    if backend.is_kernel:
        return _lookup_kernel.searchsorted_left(keys, queries)
    return torch.searchsorted(keys, queries, out_int32=True)


def searchsorted_ranged(keys, queries, lo, hi, *, backend: Backend):
    """Per-query windowed probe: ``count(keys[lo:hi] < q)`` for each query,
    ``keys`` sorted within each query's window (the shared frontier's
    per-segment runs)."""
    if backend.is_kernel:
        return _lookup_kernel.searchsorted_left_ranged(keys, queries, lo, hi)
    return _lookup_kernel.searchsorted_left_ranged_plain(keys, queries, lo,
                                                         hi)


def sort_rows(x, *, backend: Backend):
    """Row-wise ascending sort of an (R, W) i32 matrix."""
    if backend.is_kernel:
        return _dedup_kernel.sort_rows(x)
    return _dedup_ref.sort_rows(x)


def dedup_compact_rows(x, cap: int, *, backend: Backend):
    """(R, W) candidates (PAD = invalid) -> ((R, cap) sorted-unique regions,
    (R,) unique counts).  The §3.4 per-hop compaction; counts > cap is the
    fast-fail condition.  The kernel takes W up to ``DEDUP_MAX_W``."""
    if backend.is_kernel:
        return _dedup_kernel.dedup_compact_rows(x, cap)
    return _dedup_ref.dedup_compact_rows(x, cap)


def sort_pairs(k1, k2, *, backend: Backend):
    """Lexicographic ascending sort of flat (k1, k2) i32 pairs (the shared
    frontier's one compaction sort per hop)."""
    if backend.is_kernel:
        return _dedup_kernel.sort_pairs(k1, k2)
    return _dedup_ref.sort_pairs(k1, k2)


def knn_topk(vecs, emb, gid, vtype, create, delete, q_vt, q_ts, k: int, *,
             backend: Backend):
    """Squared-L2 surrogate distance and per-query top-k over the vector
    index (the ``Nearest`` probe wave): entries filtered by type and MVCC
    visibility per query, ties broken by ascending gid, empty slots
    ``(+inf, INT32_MAX)``.  Both kinds agree bit for bit."""
    args = (vecs, emb, gid, vtype, create, delete, q_vt, q_ts, k)
    if backend.is_kernel:
        return _knn_kernel.knn_topk(*args)
    return _knn_ref.knn_topk(*args)


def rmsnorm(x, scale, *, backend: Backend, eps: float = 1e-6):
    """RMSNorm over the last axis (f32 inside, x's dtype out)."""
    if backend.is_kernel:
        return _rms_ops.rmsnorm(x, scale, eps)
    return _rms_ref.rmsnorm(x, scale, eps=eps)
