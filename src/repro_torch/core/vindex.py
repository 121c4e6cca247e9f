"""Vector index: flat per-type embedding entries (the ``Nearest`` substrate).

Port of the read side of ``repro/core/vindex.py``.  The index lives in the
store (``store.vx_*``): a flat shard-major ``(S*cap_vec,)`` entry pool whose
entry is ``(gid, vtype, create_ts, delete_ts, emb)``, ``emb`` being the
vertex's whole f32 payload row.  Entries live on the vertex's own shard
(``gid % S``) and fill prefix-first per shard with an exact host count
mirror (``db.vx_count``), so the planner scans only the
:func:`vindex_window` prefix.

Registration is per vertex type (``GraphDB.vector_index(name)``): the
vertices alive at registration are backfilled with ``create_ts =
max(v_create, vdata_ts)``, so snapshots older than a vertex's last payload
write do not see its vector.  The upkeep under writes and compaction
(``apply_wave``, ``wave_demand``, ``run_compaction``) comes with the write
path and the background compaction (ROADMAP queue 1, items 7 and 9).
Unlike the JAX package, the backfill writes the store's tensors in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.addressing import TS_INF, StoreConfig
from repro_torch.core.graphdb import CapacityError
from repro_torch.core.store import GraphStore, window_shard_major


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


# ---------------------------------------------------------------------------
# registration + backfill
# ---------------------------------------------------------------------------

def register(db, vtype_name: str):
    """Register a vertex type for vector indexing; backfill live vertices."""
    vt = db.vt(vtype_name)
    if db.cfg.cap_vec <= 0:
        raise ValueError("vector index disabled: StoreConfig.cap_vec == 0")
    if vt.type_id in db._vindexed:
        return vt
    _backfill(db, vt.type_id)
    db._vindexed.add(vt.type_id)
    return vt


def _backfill(db, vtid: int) -> None:
    """Append one entry for every vertex of type ``vtid`` alive now, rows in
    ascending order, each shard filled prefix-first from its count (the JAX
    package's row loop, vectorised)."""
    st, cfg = db.store, db.cfg
    now = db.clock
    rows = torch.nonzero((st.vtype == vtid) & (st.v_create <= now)
                         & (now < st.v_delete)).reshape(-1)
    shard = rows // cfg.cap_v
    gid = ((rows % cfg.cap_v) * cfg.n_shards + shard).to(torch.int32)
    pos = _alloc(db, shard)
    create = torch.maximum(st.v_create[rows], st.vdata_ts[rows])
    _device_apply(db, pos, gid, vtid, create, st.vdata_f[rows])
    db._vx_pos.update(zip(gid.tolist(),
                          ((p, vtid) for p in pos.tolist())))


def _alloc(db, shard) -> torch.Tensor:
    """Claim the next prefix positions on the given shards, in order
    (``shard`` ascending); returns the flat entry positions."""
    S, cap = db.cfg.n_shards, db.cfg.cap_vec
    n = torch.bincount(shard, minlength=S).cpu().numpy()
    full = np.flatnonzero(db.vx_count + n > cap)
    if full.size:
        raise CapacityError(f"vector index full on shard {int(full[0])}")
    start = torch.as_tensor(db.vx_count, device=shard.device)
    # rank of each row within its shard: rows arrive grouped by shard
    first = torch.as_tensor(np.concatenate([[0], np.cumsum(n)[:-1]]),
                            device=shard.device)
    rank = torch.arange(shard.shape[0], device=shard.device) - first[shard]
    db.vx_count = db.vx_count + n
    return shard * cap + start[shard] + rank


def _device_apply(db, pos, gid, vtid: int, create, emb) -> None:
    """Write appended entries at ``pos`` (fresh, disjoint positions)."""
    st = db.store
    st.vx_gid[pos] = gid
    st.vx_vtype[pos] = int(vtid)
    st.vx_create[pos] = create
    st.vx_delete[pos] = int(TS_INF)
    st.vx_emb[pos] = emb
    st.vx_count.copy_(torch.as_tensor(db.vx_count, dtype=torch.int32))


# ---------------------------------------------------------------------------
# read-side windowing (the planners' probe wave)
# ---------------------------------------------------------------------------

def vindex_window(db) -> int:
    """Pow2 prefix window covering every live entry (a static cache key)."""
    if not db._vindexed:
        return 0
    fill = int(db.vx_count.max(initial=0))
    return min(_pow2ceil(max(fill, 1)), db.cfg.cap_vec)


def window_arrays(store: GraphStore, cfg: StoreConfig, W: int):
    """The vx_* pool cut to its ``(S*W,)`` fill-window prefix:
    (gid, vtype, create, delete, emb), contiguous."""
    S, cap = cfg.n_shards, cfg.cap_vec
    g, vt, cr, dl = (a.contiguous() for a in window_shard_major(
        (store.vx_gid, store.vx_vtype, store.vx_create, store.vx_delete),
        S, cap, W))
    emb = store.vx_emb.reshape(S, cap, -1)[:, :W].reshape(S * W, -1)
    return g, vt, cr, dl, emb.contiguous()
