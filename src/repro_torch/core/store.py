"""GraphStore: the sharded in-memory graph storage (FaRM + A1 layout, §2-3).

Port of ``repro/core/store.py``: a dataclass of int32/float32 tensors with the
same field names and shapes, all on one device.  A vertex is a header (type,
key, MVCC timestamps) plus schematized data columns in a cur/prev version
pair; edges are half-edges on both endpoints, in a compacted CSR (tier 1) and
an append-only delta log (tier 2); the primary index is a sorted array per
shard plus its own delta.  Every record carries an MVCC interval and a read
at ``read_ts`` sees it iff ``create_ts <= read_ts < delete_ts``.  Arrays are
flat and shard-major: row ``shard * cap + slot``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.addressing import NULL, TS_INF, StoreConfig


@dataclasses.dataclass
class GraphStore:
    """Device-resident graph storage (see ``repro.core.store.GraphStore`` for
    the meaning of each field)."""

    vtype: torch.Tensor       # (S*cap_v,) i32, NULL = empty slot
    vkey: torch.Tensor
    v_create: torch.Tensor
    v_delete: torch.Tensor
    v_edgever: torch.Tensor
    vdata_f: torch.Tensor     # (S*cap_v, d_f32) f32 current version
    vdata_i: torch.Tensor     # (S*cap_v, d_i32) i32
    vdata_ts: torch.Tensor
    vprev_f: torch.Tensor     # previous version
    vprev_i: torch.Tensor
    vprev_ts: torch.Tensor
    oe_indptr: torch.Tensor   # (S*(cap_v+1),) per-shard CSR offsets
    oe_dst: torch.Tensor      # (S*cap_e,)
    oe_type: torch.Tensor
    oe_create: torch.Tensor
    oe_delete: torch.Tensor
    oe_data: torch.Tensor     # (S*cap_e, d_ef32) f32
    ie_indptr: torch.Tensor
    ie_src: torch.Tensor
    ie_type: torch.Tensor
    ie_create: torch.Tensor
    ie_delete: torch.Tensor
    dl_slot: torch.Tensor     # (S*cap_delta,) out-edge delta log
    dl_nbr: torch.Tensor
    dl_type: torch.Tensor
    dl_create: torch.Tensor
    dl_delete: torch.Tensor
    dl_count: torch.Tensor    # (S,)
    il_slot: torch.Tensor     # in-edge delta log
    il_nbr: torch.Tensor
    il_type: torch.Tensor
    il_create: torch.Tensor
    il_delete: torch.Tensor
    il_count: torch.Tensor
    ix_vtype: torch.Tensor    # (S*cap_idx,) primary index, sorted per shard
    ix_key: torch.Tensor
    ix_gid: torch.Tensor
    ix_create: torch.Tensor
    ix_delete: torch.Tensor
    ix_count: torch.Tensor
    xd_vtype: torch.Tensor    # (S*cap_idx_delta,) primary-index delta
    xd_key: torch.Tensor
    xd_gid: torch.Tensor
    xd_create: torch.Tensor
    xd_delete: torch.Tensor
    xd_count: torch.Tensor
    vx_gid: torch.Tensor      # (S*cap_vec,) vector index
    vx_vtype: torch.Tensor
    vx_create: torch.Tensor
    vx_delete: torch.Tensor
    vx_emb: torch.Tensor      # (S*cap_vec, d_f32) f32
    vx_count: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.vtype.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


FIELDS = tuple(f.name for f in dataclasses.fields(GraphStore))


def _layout(cfg: StoreConfig) -> dict:
    """field -> (shape, fill, dtype) of an empty store."""
    S = cfg.n_shards
    V, E, D, X, XD = (S * cfg.cap_v, S * cfg.cap_e, S * cfg.cap_delta,
                      S * cfg.cap_idx, S * cfg.cap_idx_delta)
    VX = S * cfg.cap_vec
    P = S * (cfg.cap_v + 1)
    i, f = torch.int32, torch.float32
    n, inf = int(NULL), int(TS_INF)
    out = dict(
        vtype=((V,), n, i), vkey=((V,), 0, i), v_create=((V,), inf, i),
        v_delete=((V,), inf, i), v_edgever=((V,), 0, i),
        vdata_f=((V, cfg.d_f32), 0, f), vdata_i=((V, cfg.d_i32), 0, i),
        vdata_ts=((V,), 0, i),
        vprev_f=((V, cfg.d_f32), 0, f), vprev_i=((V, cfg.d_i32), 0, i),
        vprev_ts=((V,), 0, i),
        oe_indptr=((P,), 0, i), oe_dst=((E,), n, i), oe_type=((E,), n, i),
        oe_create=((E,), inf, i), oe_delete=((E,), inf, i),
        oe_data=((E, cfg.d_ef32), 0, f),
        ie_indptr=((P,), 0, i), ie_src=((E,), n, i), ie_type=((E,), n, i),
        ie_create=((E,), inf, i), ie_delete=((E,), inf, i),
    )
    for p in ("dl", "il"):
        out.update({f"{p}_slot": ((D,), n, i), f"{p}_nbr": ((D,), n, i),
                    f"{p}_type": ((D,), n, i), f"{p}_create": ((D,), inf, i),
                    f"{p}_delete": ((D,), inf, i), f"{p}_count": ((S,), 0, i)})
    for p, L in (("ix", X), ("xd", XD)):
        out.update({f"{p}_vtype": ((L,), inf, i), f"{p}_key": ((L,), inf, i),
                    f"{p}_gid": ((L,), n, i), f"{p}_create": ((L,), inf, i),
                    f"{p}_delete": ((L,), inf, i), f"{p}_count": ((S,), 0, i)})
    out.update(vx_gid=((VX,), n, i), vx_vtype=((VX,), n, i),
               vx_create=((VX,), inf, i), vx_delete=((VX,), inf, i),
               vx_emb=((VX, cfg.d_f32), 0, f), vx_count=((S,), 0, i))
    return out


def make_store(cfg: StoreConfig, device) -> GraphStore:
    """Allocate an empty store on ``device``."""
    return GraphStore(**{
        name: torch.full(shape, fill, dtype=dtype, device=device)
        for name, (shape, fill, dtype) in _layout(cfg).items()})


def make_store_shapes(cfg: StoreConfig) -> GraphStore:
    """An empty store's fields as ``meta`` tensors (the dry run's shapes:
    no allocation)."""
    return make_store(cfg, "meta")


def store_from_numpy(cfg: StoreConfig, arrays: dict, device) -> GraphStore:
    """Carry a store across: ``arrays`` maps every field name to a numpy
    array of the field's shape; values are copied to ``device`` unchanged."""
    layout = _layout(cfg)
    missing = set(layout) - set(arrays)
    if missing:
        raise ValueError(f"store_from_numpy: missing fields {sorted(missing)}")
    out = {}
    for name, (shape, _, dtype) in layout.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"store_from_numpy: {name} has shape {a.shape}, "
                             f"the config says {shape}")
        out[name] = torch.as_tensor(
            a.astype(np.float32 if dtype == torch.float32 else np.int32),
            device=device)
    return GraphStore(**out)


# ---------------------------------------------------------------------------
# visibility & gathers (snapshot reads, §5.2)
# ---------------------------------------------------------------------------

def visible(create_ts, delete_ts, read_ts):
    """MVCC visibility: created at-or-before the snapshot, not yet deleted."""
    return (create_ts <= read_ts) & (delete_ts > read_ts)


def window_shard_major(arrs, S: int, cap: int, W: int):
    """Slice shard-major ``(S*cap,)`` delta arrays to their ``(S*W,)``
    fill-window prefix (delta logs fill prefix-first per shard, so ``[:W]``
    of each shard block sees every live entry)."""
    return tuple(a.reshape(S, cap)[:, :W].reshape(-1) for a in arrs)


def replay_log_tail(dst, src, w, n, *, cap: int):
    """Copy each shard's log tail ``[w_s, n_s)`` from ``src`` onto a copy
    of ``dst`` at ``[0, n_s - w_s)``.  Flat shard-major ``(S*cap,)``
    tensors; ``w`` and ``n`` are ``(S,)`` integer tensors.

    The compaction-handoff primitive (§2.2 concurrent GC): ``dst`` is the
    shadow store's freshly emptied delta log, ``src`` the live log, ``w``
    the per-shard fill at shadow-build time and ``n`` the fill now.
    Positions past the tail keep ``dst``'s empty-log fill (the prefix-fill
    invariant behind ``planner.delta_window``).  The JAX package scatters
    every position and drops the ones past the tail at an out-of-bounds
    row; here they are masked out before the scatter (an out-of-range CUDA
    index is fatal).  Neither ``dst`` nor ``src`` is written."""
    S = w.shape[0]
    dev = dst.device
    k = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    base = (torch.arange(S, dtype=torch.int64, device=dev) * cap)[:, None]
    src_pos = w.to(device=dev, dtype=torch.int64)[:, None] + k
    valid = (src_pos < n.to(device=dev, dtype=torch.int64)[:, None]
             ).reshape(-1)
    # a valid read lies in [0, S*cap) whenever n <= cap; the clamp is the
    # JAX gather's, for counts past a shard's cap
    rows = torch.clamp(base + src_pos, max=src.shape[0] - 1).reshape(-1)
    out = dst.clone()
    out[(base + k).reshape(-1)[valid]] = src[rows[valid]]
    return out


def lexsort(keys, operands):
    """Sort ``operands`` by ``keys`` (first key most significant) with
    stable sorts from the last key to the first, so ties keep their input
    order (the compactions' multi-key sorts)."""
    perm = None
    for k in reversed(keys):
        p = torch.sort(k if perm is None else k[perm], stable=True).indices
        perm = p if perm is None else perm[p]
    return [x[perm] for x in operands]


def gather_headers(store: GraphStore, cfg: StoreConfig, gids, read_ts):
    """Vertex headers of ``gids`` at snapshot ``read_ts``: (vtype, key,
    alive), NULL/False for invalid or invisible ids."""
    ok = gids >= 0
    rows = cfg.row_of_gid(torch.where(ok, gids, 0))
    alive = ok & visible(store.v_create[rows], store.v_delete[rows], read_ts)
    return (torch.where(alive, store.vtype[rows], int(NULL)),
            torch.where(alive, store.vkey[rows], int(NULL)), alive)


def gather_data(store: GraphStore, cfg: StoreConfig, gids, read_ts):
    """Vertex data columns at a snapshot: the current or previous version by
    timestamp, zeros for invisible ids."""
    ok = gids >= 0
    rows = cfg.row_of_gid(torch.where(ok, gids, 0))
    use_cur = (store.vdata_ts[rows] <= read_ts)[:, None]
    f = torch.where(use_cur, store.vdata_f[rows], store.vprev_f[rows])
    i = torch.where(use_cur, store.vdata_i[rows], store.vprev_i[rows])
    alive = ok & visible(store.v_create[rows], store.v_delete[rows], read_ts)
    return f * alive[:, None], i * alive[:, None], alive
