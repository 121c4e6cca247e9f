"""Vector index: flat per-type embedding entries (the ``Nearest`` substrate).

Port of ``repro/core/vindex.py``.  The index lives in the
store (``store.vx_*``): a flat shard-major ``(S*cap_vec,)`` entry pool whose
entry is ``(gid, vtype, create_ts, delete_ts, emb)``, ``emb`` being the
vertex's whole f32 payload row.  Entries live on the vertex's own shard
(``gid % S``) and fill prefix-first per shard with an exact host count
mirror (``db.vx_count``), so the planner scans only the
:func:`vindex_window` prefix.

Registration is per vertex type (``GraphDB.vector_index(name)``): the
vertices alive at registration are backfilled with ``create_ts =
max(v_create, vdata_ts)``, so snapshots older than a vertex's last payload
write do not see its vector.  Upkeep is versioned, not in place: a write wave's payload
update tombstones the old entry at the wave's ``ts`` and appends a fresh one
at the same ``ts`` (:func:`apply_wave`), so ``Nearest`` at an old
``read_ts`` still sees the old vector; the fold (:func:`run_compaction`)
drops entries dead at ``gc_ts`` and prefix-compacts each shard.  Unlike the
JAX package, the backfill and the waves write the store's tensors in place,
and the fold runs on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.addressing import NULL, TS_INF, StoreConfig
from repro_torch.core.store import GraphStore, window_shard_major
from repro_torch.core.writes import CapacityError


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


def _alloc_gid(db, gid: int) -> int:
    """Claim the next prefix position on the gid's owning shard (the write
    wave's allocator, one entry at a time)."""
    s = int(gid) % db.cfg.n_shards
    p = int(db.vx_count[s])
    if p >= db.cfg.cap_vec:
        raise CapacityError(f"vector index full on shard {s}")
    db.vx_count[s] = p + 1
    return s * db.cfg.cap_vec + p


def _device_apply(db, pos, gid, vtid, create, emb, tomb=None,
                  ts: int = 0) -> None:
    """Tombstone the entries at ``tomb`` at ``ts``, then write appended
    entries at ``pos`` (fresh, disjoint positions), in that order."""
    st = db.store
    if tomb is not None:
        st.vx_delete[tomb] = int(ts)
    st.vx_gid[pos] = gid
    st.vx_vtype[pos] = vtid
    st.vx_create[pos] = create
    st.vx_delete[pos] = int(TS_INF)
    st.vx_emb[pos] = emb
    st.vx_count.copy_(torch.as_tensor(db.vx_count, dtype=torch.int32))


# ---------------------------------------------------------------------------
# write-wave upkeep (called by writes.commit_wave for each applied chunk)
# ---------------------------------------------------------------------------

def wave_demand(db, txns) -> np.ndarray:
    """Exact per-shard append demand of a winner batch (the capacity
    backstop): a create of an indexed type and a payload update of an
    indexed vertex each append one entry; gids created earlier in the same
    batch count as indexed."""
    S = db.cfg.n_shards
    need = np.zeros(S, np.int64)
    fresh: set = set()
    for t in txns:
        for gid, vtid, *_ in t.create_v:
            if vtid in db._vindexed:
                need[int(gid) % S] += 1
                fresh.add(gid)
        for gid, _f, _i in t.update_v:
            if gid in db._vx_pos or gid in fresh:
                need[int(gid) % S] += 1
    return need


def apply_wave(db, chunk, ts: int) -> None:
    """Fold one applied mutation chunk into the vector index at ``ts``: a
    create of an indexed type appends an entry; an update of an indexed
    vertex tombstones its entry at ``ts`` and appends the new payload at
    ``ts`` (at most one entry a gid visible at any snapshot); a delete
    tombstones."""
    if not db._vindexed:
        return
    appends = []   # (pos, gid, vtid, emb row)
    tombs = []     # positions whose delete_ts becomes ts
    for t in chunk:
        for gid, vtid, _key, f, _i in t.create_v:
            if vtid in db._vindexed:
                pos = _alloc_gid(db, gid)
                db._vx_pos[gid] = (pos, vtid)
                appends.append((pos, gid, vtid, f))
        for gid, f, _i in t.update_v:
            ent = db._vx_pos.get(gid)
            if ent is not None:
                tombs.append(ent[0])
                pos = _alloc_gid(db, gid)
                db._vx_pos[gid] = (pos, ent[1])
                appends.append((pos, gid, ent[1], f))
        for gid, *_ in t.delete_v:
            ent = db._vx_pos.pop(gid, None)
            if ent is not None:
                tombs.append(ent[0])
    if not appends and not tombs:
        return
    dev = db.device

    def i64(xs):
        return torch.as_tensor(np.asarray(xs, np.int64), device=dev)

    def i32(xs):
        return torch.as_tensor(np.asarray(xs, np.int32), device=dev)
    emb = np.zeros((len(appends), db.cfg.d_f32), np.float32)
    for j, a in enumerate(appends):
        emb[j] = np.asarray(a[3], np.float32)
    _device_apply(db, i64([a[0] for a in appends]),
                  i32([a[1] for a in appends]), i32([a[2] for a in appends]),
                  int(ts), torch.as_tensor(emb, device=dev),
                  tomb=i64(tombs), ts=ts)


# ---------------------------------------------------------------------------
# compaction fold (the "vindex" kind of the background lifecycle)
# ---------------------------------------------------------------------------

def run_compaction(db) -> None:
    """Fold: drop the entries dead at ``gc_ts`` (or empty), prefix-compact
    each shard in a stable order, rebuild the host position map.

    On the device: an entry's new position is its shard's base plus the
    number of kept entries before it in the shard (a cumulative sum), so
    each shard keeps its order; only the live entries' (gid, position,
    type) come back to the host, for ``db._vx_pos``."""
    cfg = db.cfg
    if cfg.cap_vec <= 0:
        return
    gc = db.gc_ts()
    S, cap = cfg.n_shards, cfg.cap_vec
    st = db.store
    keep = ((st.vx_gid >= 0) & (st.vx_delete > gc)).view(S, cap)
    n = keep.sum(dim=1)
    rank = torch.cumsum(keep, dim=1) - 1
    base = torch.arange(S, device=keep.device)[:, None] * cap
    src = torch.nonzero(keep.reshape(-1)).reshape(-1)
    dst = (base + rank).reshape(-1)[src]
    out = {}
    for name, fill in (("vx_gid", NULL), ("vx_vtype", NULL),
                       ("vx_create", TS_INF), ("vx_delete", TS_INF),
                       ("vx_emb", 0)):
        a = getattr(st, name)
        b = torch.full_like(a, int(fill))
        b[dst] = a[src]
        out[name] = b
    for name, b in out.items():
        setattr(st, name, b)
    db.vx_count = n.cpu().numpy().astype(np.int64)
    st.vx_count.copy_(n.to(torch.int32))
    live = out["vx_delete"][dst] == int(TS_INF)
    g, p, t = (x[live].tolist() for x in (out["vx_gid"][dst], dst,
                                          out["vx_vtype"][dst]))
    db._vx_pos = {gg: (pp, tt) for gg, pp, tt in zip(g, p, t)}
    db.stats["vindex_compactions"] += 1


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
