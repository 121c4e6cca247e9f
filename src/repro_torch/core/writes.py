"""Write path: batched mutation waves behind ``GraphDB.write()`` (§3, §2.2).

Port of ``repro/core/writes.py``.

* **Typed mutation-op records** (:class:`CreateVertex` ... :class:`DeleteEdge`)
  are the write-side IR.  ``GraphDB.write(ops)`` is the one entry point; the
  per-op methods (``create_vertex`` et al.) stage these records, and
  ``commit`` / ``commit_many`` are DeprecationWarning shims.  Per-op results
  (gid, status, abort reason) come back positionally in a
  :class:`WriteResult`.
* **One OCC validation wave** per commit batch: every transaction's read set
  is concatenated and validated by one gather (``last_write_ts`` against
  each read's snapshot); intra-batch conflicts resolve first-wins (§3).
* **One apply per chunk**: winners are chunked under the ``BatchCaps``, each
  chunk's op arrays padded to pow2 buckets per op kind and applied by
  ``txn.apply_batch_impl`` at the chunk's own commit timestamp.  The JAX
  package keeps a cache of jitted programs keyed on the bucket tuple; eager
  PyTorch traces nothing, so the bodies are called directly.
* **Inline compaction is the overflow backstop only**: crossing the fill
  watermark schedules the background task, when a task queue is attached.

Op payloads (attribute rows) stay numpy on the host, so a chunk's wave
record is JSON-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import index as index_mod
from repro_torch.core import txn as txn_mod


class CapacityError(RuntimeError):
    """A store/log/batch static capacity would be exceeded."""


# ---------------------------------------------------------------------------
# Typed mutation-op records (the write-side IR)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CreateVertex:
    vtype: str
    key: int
    attrs: Optional[dict] = None
    hint: Optional[int] = None        # FaRM locality hint (co-locate shard)


@dataclasses.dataclass(frozen=True)
class UpdateVertex:
    gid: int
    vtype: str
    attrs: dict


@dataclasses.dataclass(frozen=True)
class DeleteVertex:
    gid: int


@dataclasses.dataclass(frozen=True)
class CreateEdge:
    src: int
    dst: int
    etype: str
    check: bool = True                # False = bulk-load fast path (§3)


@dataclasses.dataclass(frozen=True)
class DeleteEdge:
    src: int
    dst: int
    etype: str


WriteOp = Union[CreateVertex, UpdateVertex, DeleteVertex, CreateEdge,
                DeleteEdge]
_OP_TYPES = (CreateVertex, UpdateVertex, DeleteVertex, CreateEdge, DeleteEdge)


@dataclasses.dataclass
class WriteResult:
    """Per-entry outcomes of one ``GraphDB.write`` call, positionally aligned
    with the input list.

    ``statuses[i]`` is ``"COMMITTED"`` / ``"ABORTED"`` / ``"STAGED"`` (op
    records staged into an open transaction).  ``gids[i]`` is the allocated
    vertex gid of a ``CreateVertex`` entry (-1 otherwise, and -1 when the
    batch aborted).  ``reasons[i]`` is the abort reason or ``None``.  ``ts``
    is the clock after the wave (-1 for stage-only calls)."""
    statuses: list
    gids: list
    reasons: list
    ts: int = -1

    @property
    def failed(self) -> bool:
        return any(s == "ABORTED" for s in self.statuses)


# ---------------------------------------------------------------------------
# Staging: op record -> Transaction
# ---------------------------------------------------------------------------

def stage(db, op: WriteOp, t) -> int:
    """Stage one mutation-op record into an open transaction.

    Performs the record's read-validate round trips at ``t.read_ts`` (reads
    recorded for OCC), raises ``ValueError`` on contract violations, and
    returns the allocated gid for ``CreateVertex`` (-1 for every other
    kind)."""
    if isinstance(op, CreateVertex):
        vt = db.vt(op.vtype)
        g, found = db.lookup_vertex(op.vtype, int(op.key), read_ts=t.read_ts)
        if found:
            raise ValueError(f"vertex ({op.vtype}, {op.key}) already exists")
        f, i = db._encode_attrs(vt, op.attrs or {})
        gid = db._alloc_vertex(op.hint)
        t.create_v.append((gid, vt.type_id, int(op.key), f, i))
        return gid
    if isinstance(op, UpdateVertex):
        vt = db.vt(op.vtype)
        cur_f, cur_i = db._read_data_host(op.gid, t.read_ts)
        t.record_read(op.gid)
        f, i = db._encode_attrs(vt, op.attrs, base_f=cur_f, base_i=cur_i)
        t.update_v.append((op.gid, f, i))
        return -1
    if isinstance(op, DeleteVertex):
        # §3.2 cascade: the incoming list names every source whose outgoing
        # half-edge must also be retired
        gid = op.gid
        vtid, key, alive = db._read_header_host(gid, t.read_ts)
        t.record_read(gid)
        if not alive:
            raise ValueError(f"vertex {gid} not found")
        outs = db.get_edges(gid, direction="out", read_ts=t.read_ts)
        ins = db.get_edges(gid, direction="in", read_ts=t.read_ts)
        for nbr, et in outs:
            t.delete_e.append((gid, int(nbr), int(et)))
        for nbr, et in ins:
            t.delete_e.append((int(nbr), gid, int(et)))
        t.delete_v.append((gid, int(vtid), int(key)))
        return -1
    if isinstance(op, CreateEdge):
        et = db.et(op.etype)
        if op.check:
            for g in (op.src, op.dst):
                _, _, alive = db._read_header_host(g, t.read_ts)
                t.record_read(g)
                if not alive:
                    raise ValueError(f"endpoint {g} not found")
            # single-edge-per-(src,type,dst) invariant (§3)
            existing = db.get_edges(op.src, direction="out",
                                    read_ts=t.read_ts, etype=et.type_id)
            t.reads.append((int(op.src), "e"))
            if any(int(n) == int(op.dst) for n, _ in existing):
                raise ValueError("edge already exists")
        t.create_e.append((int(op.src), int(op.dst), et.type_id))
        return -1
    if isinstance(op, DeleteEdge):
        et = db.et(op.etype)
        t.reads.append((int(op.src), "e"))
        t.delete_e.append((int(op.src), int(op.dst), et.type_id))
        return -1
    raise TypeError(f"not a mutation-op record: {type(op).__name__}")


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _bucket(n: int) -> int:
    """Op-count bucket: 0 stays 0, everything else rounds up to a pow2."""
    return 0 if n == 0 else _pow2ceil(n)


# ---------------------------------------------------------------------------
# The commit wave
# ---------------------------------------------------------------------------

def _validate(db, gids, kinds, rts) -> np.ndarray:
    """One OCC validation wave over ``P`` padded reads: per read, whether
    the object's last write landed after the owning transaction's snapshot.
    Padded rows (gid -1, rts 0) have ``last_write_ts == 0`` and never
    conflict."""
    P = _pow2ceil(len(gids))
    dev = db.device
    lw = txn_mod.last_write_ts(db.store, db.cfg,
                               txn_mod.pad_i32(gids, P, device=dev),
                               txn_mod.pad_i32(kinds, P, fill=0, device=dev))
    return (lw > txn_mod.pad_i32(rts, P, fill=0, device=dev)).cpu().numpy()


def commit_wave(db, txns: Sequence, caps=None):
    """Validate and apply a batch of transactions as mutation waves.

    Returns ``(statuses, reasons)`` per transaction:

    1. one vectorised OCC validation wave over all read sets (per-read
       snapshot timestamps, so mixed-snapshot batches validate in one pass);
    2. host-side first-wins intra-batch resolution;
    3. inline compaction only as the overflow backstop (``delete_e`` entries
       count too: a tombstone-laden log reclaims space only at compaction);
    4. winners chunked under ``BatchCaps``, each chunk applied at its own
       commit timestamp and recorded as one wave record.

    After the wave, crossing the delta-log fill watermark schedules the
    background compaction task (never compacts inline here)."""
    caps = caps or db.caps
    txns = list(txns)

    # 1) OCC validation: one wave over every transaction's read set -------
    gids, kinds, owner, rts = [], [], [], []
    for i, t in enumerate(txns):
        for g, kind in t.reads:
            gids.append(g)
            kinds.append(1 if kind == "e" else 0)
            owner.append(i)
            rts.append(t.read_ts)
    status = ["COMMITTED"] * len(txns)
    reason: list = [None] * len(txns)
    if gids:
        conflict = _validate(db, gids, kinds, rts)
        for i, c in zip(owner, conflict[:len(gids)]):
            if bool(c) and status[i] == "COMMITTED":
                status[i] = "ABORTED"
                reason[i] = "stale read (OCC validation)"

    # 2) intra-batch conflicts, first-wins (§3): a later txn aborts if it
    #    writes an object an earlier winner wrote, or reads an object an
    #    earlier winner wrote
    taken: set = set()
    for i, t in enumerate(txns):
        if status[i] == "ABORTED":
            continue
        wk = t.write_keys()
        if wk & taken:
            status[i] = "ABORTED"
            reason[i] = "intra-batch write-write conflict (first wins)"
        elif t.read_keys() & taken:
            status[i] = "ABORTED"
            reason[i] = "intra-batch read-write conflict (first wins)"
        else:
            taken |= wk
    winners = [t for i, t in enumerate(txns) if status[i] == "COMMITTED"]
    if winners:
        # 3) capacity backstop: inline-compact only if the logs would
        #    overflow.  A wave refused here or by the caps raises
        #    CapacityError with its transactions still OPEN (the JAX
        #    package marks them first), so none reads COMMITTED unapplied
        _ensure_capacity(db, winners)
        chunks = _chunks(winners, caps)
    for i, t in enumerate(txns):
        t.status = status[i]
    if not winners:
        db.stats["aborts"] += len(txns)
        return status, reason

    # 4) apply winners, chunked under the batch caps at increasing
    #    timestamps; each chunk becomes one wave record (§4)
    for chunk in chunks:
        ts = db.clock + 1
        _apply_chunk(db, chunk, ts)
        seq = db.wave_seq + 1
        rec = wave_record(db, chunk, ts, seq)
        db.wave_seq = seq
        db.wave_log.append(rec)
        _remember_rids(db, chunk, ts)
    db.stats["commits"] += len(winners)
    db.stats["aborts"] += len(txns) - len(winners)
    db.stats["write_waves"] += 1
    db._maybe_schedule_compaction()
    return status, reason


def _ensure_capacity(db, winners) -> None:
    """Step 3 of the wave: inline-compact only as the overflow backstop."""
    cfg = db.cfg
    n_ce = sum(len(t.create_e) for t in winners)
    n_de = sum(len(t.delete_e) for t in winners)
    n_cv = sum(len(t.create_v) for t in winners)
    n_dv = sum(len(t.delete_v) for t in winners)
    if (db.dl_count.max(initial=0) + n_ce + n_de > cfg.cap_delta
            or db.il_count.max(initial=0) + n_ce + n_de > cfg.cap_delta):
        db.run_compaction()
    if db.xd_count.max(initial=0) + n_cv + n_dv > cfg.cap_idx_delta:
        db.run_index_compaction()
    if db._vindexed:
        from repro_torch.core import vindex as vindex_mod
        need = vindex_mod.wave_demand(db, winners)
        if np.any(db.vx_count + need > cfg.cap_vec):
            db.run_vindex_compaction()
            if np.any(db.vx_count + need > cfg.cap_vec):
                raise CapacityError("vector index full; raise cap_vec")
    _check_log_room(db, winners)


def _check_log_room(db, winners) -> None:
    """Refuse a batch whose appends would run past a shard's delta log or
    index delta even after the backstop.  The JAX package writes such
    appends into the next shard's block (or drops them past the last
    one); here the scatter would index out of bounds, so the wave raises
    before anything is applied.  Batches that fit are not affected."""
    cfg, S = db.cfg, db.cfg.n_shards
    dl, il, xd = (c.copy() for c in (db.dl_count, db.il_count, db.xd_count))
    for t in winners:
        for s, d, _ in t.create_e:
            dl[s % S] += 1
            il[d % S] += 1
        for _, vtid, key, *_ in t.create_v:
            xd[index_mod.route_host(vtid, key, S)] += 1
    if max(dl.max(initial=0), il.max(initial=0)) > cfg.cap_delta:
        raise CapacityError("edge delta log full; raise cap_delta")
    if xd.max(initial=0) > cfg.cap_idx_delta:
        raise CapacityError("index delta full; raise cap_idx_delta")


def _apply_chunk(db, chunk, ts: int) -> None:
    """Apply one winner chunk at commit timestamp ``ts`` (shared by commit
    and replay)."""
    txn_mod.apply_batch_impl(db.store, db.cfg, ts, *_build_wave(db, chunk))
    db.clock = max(db.clock, ts)
    if db._vindexed:
        from repro_torch.core import vindex as vindex_mod
        vindex_mod.apply_wave(db, chunk, ts)
    if any(t.delete_e for t in chunk):
        db.epochs["delete_e"] += 1
    if any(t.delete_v for t in chunk):
        db.epochs["delete_v"] += 1


def _remember_rids(db, chunk, ts: int) -> None:
    """Record each committed txn's client rid -> outcome (exactly-once
    across failover: a re-admitted rid returns the original result)."""
    for t in chunk:
        rid = getattr(t, "rid", None)
        if rid is None:
            continue
        db.applied_rids[rid] = {
            "ts": int(ts), "gids": [int(g) for g, *_ in t.create_v]}
    while len(db.applied_rids) > 4096:
        db.applied_rids.popitem(last=False)


# ---------------------------------------------------------------------------
# Wave records: the unit of fleet replication (§4)
# ---------------------------------------------------------------------------

def _edge_ident(db, gid: int, ts: int) -> tuple:
    vt, key, alive = db._read_header_host(gid, ts)
    if not alive:                   # deleted in the same batch: pre-state
        vt, key, _ = db._read_header_host(gid, ts - 1)
    return int(vt), int(key)


def wave_record(db, chunk, ts: int, seq: int) -> dict:
    """One committed chunk as a JSON-safe record: the physical op arrays
    (primary-assigned gids ship verbatim) plus the logical identities
    resolved at commit time (update targets, edge endpoints)."""
    txns = []
    for t in chunk:
        uv = []
        for gid, f, i in t.update_v:
            vt, key, _ = db._read_header_host(gid, ts)
            uv.append([int(gid), int(vt), int(key),
                       np.asarray(f).tolist(), np.asarray(i).tolist()])
        txns.append({
            "rid": getattr(t, "rid", None),
            "create_v": [[int(g), int(vt), int(k),
                          np.asarray(f).tolist(), np.asarray(i).tolist()]
                         for g, vt, k, f, i in t.create_v],
            "update_v": uv,
            "delete_v": [[int(g), int(vt), int(k)]
                         for g, vt, k in t.delete_v],
            "create_e": [[int(s), int(d), int(et),
                          *_edge_ident(db, s, ts), *_edge_ident(db, d, ts)]
                         for s, d, et in t.create_e],
            "delete_e": [[int(s), int(d), int(et),
                          *_edge_ident(db, s, ts), *_edge_ident(db, d, ts)]
                         for s, d, et in t.delete_e],
        })
    return {"seq": int(seq), "ts": int(ts),
            "epoch": int(getattr(db, "config_epoch", 0)), "txns": txns}


def replay_wave(db, rec: dict) -> int:
    """Apply one shipped wave record on a replica, at the record's original
    commit timestamp.  Idempotent: a record at or below the local wave
    frontier is skipped; a gap raises (the replica needs a full resync).
    Returns 1 when applied, 0 when skipped."""
    seq = int(rec["seq"])
    if seq <= db.wave_seq:
        return 0
    if seq != db.wave_seq + 1:
        raise ValueError(
            f"replication gap: local frontier {db.wave_seq}, got {seq}; "
            "full resync required")
    ts = int(rec["ts"])
    chunk = []
    for tr in rec["txns"]:
        t = txn_mod.Transaction(read_ts=0)
        t.rid = tr.get("rid")
        t.status = "COMMITTED"
        for g, vt, k, f, i in tr["create_v"]:
            t.create_v.append((int(g), int(vt), int(k),
                               np.asarray(f, np.float32),
                               np.asarray(i, np.int32)))
        for g, vt, k, f, i in tr["update_v"]:
            t.update_v.append((int(g), np.asarray(f, np.float32),
                               np.asarray(i, np.int32)))
        t.delete_v = [(int(g), int(vt), int(k))
                      for g, vt, k in tr["delete_v"]]
        t.create_e = [(int(s), int(d), int(et))
                      for s, d, et, *_ in tr["create_e"]]
        t.delete_e = [(int(s), int(d), int(et))
                      for s, d, et, *_ in tr["delete_e"]]
        chunk.append(t)
    _ensure_capacity(db, chunk)
    # reserve primary-assigned gids: a promoted replica must never
    # re-allocate a slot the old primary already handed out
    S = db.cfg.n_shards
    for t in chunk:
        for g, *_ in t.create_v:
            sh, slot = int(g) % S, int(g) // S
            if db.v_next[sh] <= slot:
                db.v_next[sh] = slot + 1
            elif slot in db.v_free[sh]:
                db.v_free[sh].remove(slot)
    _apply_chunk(db, chunk, ts)
    db.wave_seq = seq
    db.wave_log.append(rec)
    db.config_epoch = max(db.config_epoch, int(rec.get("epoch", 0)))
    _remember_rids(db, chunk, ts)
    db.stats["replayed_waves"] = db.stats.get("replayed_waves", 0) + 1
    db._maybe_schedule_compaction()
    return 1


def _chunks(winners, caps):
    out, acc = [], []
    ncv = nuv = ndv = nce = nde = 0
    for t in winners:
        if acc and (ncv + len(t.create_v) > caps.create_v
                    or nuv + len(t.update_v) > caps.update_v
                    or ndv + len(t.delete_v) > caps.delete_v
                    or nce + len(t.create_e) > caps.create_e
                    or nde + len(t.delete_e) > caps.delete_e):
            out.append(acc)
            acc, ncv, nuv, ndv, nce, nde = [], 0, 0, 0, 0, 0
        acc.append(t)
        ncv += len(t.create_v)
        nuv += len(t.update_v)
        ndv += len(t.delete_v)
        nce += len(t.create_e)
        nde += len(t.delete_e)
        if (len(t.create_v) > caps.create_v or len(t.update_v) > caps.update_v
                or len(t.delete_v) > caps.delete_v
                or len(t.create_e) > caps.create_e
                or len(t.delete_e) > caps.delete_e):
            raise CapacityError(
                "single transaction exceeds batch caps; raise BatchCaps")
    if acc:
        out.append(acc)
    return out


def _build_wave(db, chunk):
    """Pad one winner chunk's op arrays to their pow2 bucket per op kind
    (the JAX package's program-cache key) and assign host-side log
    positions (the delta/index fill mirrors advance here).  Returns
    ``apply_batch_impl``'s op arguments."""
    cfg = db.cfg
    S = cfg.n_shards
    dev = db.device
    cv, uv, dv, ce, de = [], [], [], [], []
    for t in chunk:
        cv += t.create_v
        uv += t.update_v
        dv += t.delete_v
        ce += t.create_e
        de += t.delete_e
    bcv, buv, bdv, bce, bde = (_bucket(len(x)) for x in (cv, uv, dv, ce, de))

    # index-delta positions for creates (host-assigned, per index shard)
    xpos = []
    for gid, vtid, key, f, i in cv:
        sh = index_mod.route_host(vtid, key, S)
        xpos.append(sh * cfg.cap_idx_delta + int(db.xd_count[sh]))
        db.xd_count[sh] += 1
    # delta-log positions for edge creates
    opos, ipos = [], []
    for s, d, et in ce:
        so, sd = s % S, d % S
        opos.append(so * cfg.cap_delta + int(db.dl_count[so]))
        db.dl_count[so] += 1
        ipos.append(sd * cfg.cap_delta + int(db.il_count[sd]))
        db.il_count[sd] += 1

    def p32(xs, cap):
        return txn_mod.pad_i32(xs, cap, device=dev)

    def count(c):
        return torch.as_tensor(c.astype(np.int32), device=dev)
    return (
        p32([x[0] for x in cv], bcv),
        p32([x[1] for x in cv], bcv),
        p32([x[2] for x in cv], bcv),
        txn_mod.pad_f32([x[3] for x in cv], bcv, cfg.d_f32, device=dev),
        txn_mod.pad_i32_2d([x[4] for x in cv], bcv, cfg.d_i32, device=dev),
        p32(xpos, bcv),
        p32([x[0] for x in uv], buv),
        txn_mod.pad_f32([x[1] for x in uv], buv, cfg.d_f32, device=dev),
        txn_mod.pad_i32_2d([x[2] for x in uv], buv, cfg.d_i32, device=dev),
        p32([x[0] for x in dv], bdv),
        p32([x[1] for x in dv], bdv),
        p32([x[2] for x in dv], bdv),
        p32([x[0] for x in ce], bce),
        p32([x[1] for x in ce], bce),
        p32([x[2] for x in ce], bce),
        p32(opos, bce),
        p32(ipos, bce),
        p32([x[0] for x in de], bde),
        p32([x[1] for x in de], bde),
        p32([x[2] for x in de], bde),
        count(db.dl_count), count(db.il_count), count(db.xd_count),
    )


# ---------------------------------------------------------------------------
# The entry point (exported as GraphDB.write)
# ---------------------------------------------------------------------------

def write(db, ops, *, txn=None, caps=None) -> WriteResult:
    """Execute a batch of mutations (see ``GraphDB.write`` for the API).

    ``ops`` is either a list of mutation-op records or a list of staged
    ``Transaction`` objects (never mixed).  Op records with ``txn=`` stage
    only; without, they form one implicit atomic transaction committed
    immediately.  Transactions commit as one mutation wave.  Staging
    contract violations raise ``ValueError`` synchronously; commit-time OCC
    outcomes come back as per-entry statuses and abort reasons."""
    ops = list(ops)
    if not ops:
        raise ValueError("write() needs at least one op or transaction")
    if isinstance(ops[0], txn_mod.Transaction):
        if txn is not None:
            raise ValueError("txn= only applies to mutation-op records")
        if not all(isinstance(o, txn_mod.Transaction) for o in ops):
            raise TypeError("cannot mix transactions and op records")
        statuses, reasons = commit_wave(db, ops, caps)
        return WriteResult(statuses=statuses, gids=[-1] * len(ops),
                           reasons=reasons, ts=db.clock)
    for op in ops:
        if not isinstance(op, _OP_TYPES):
            raise TypeError(f"not a mutation-op record: {type(op).__name__}")
    if txn is not None:
        t, _ = db._txn(txn)
        gids = [stage(db, op, t) for op in ops]
        return WriteResult(statuses=["STAGED"] * len(ops), gids=gids,
                           reasons=[None] * len(ops), ts=-1)
    # implicit transaction: the whole op list commits atomically (§3)
    t = db.create_transaction()
    gids = [stage(db, op, t) for op in ops]
    statuses, reasons = commit_wave(db, [t], caps)
    committed = statuses[0] == "COMMITTED"
    return WriteResult(
        statuses=[statuses[0]] * len(ops),
        gids=gids if committed else [-1] * len(ops),
        reasons=[reasons[0]] * len(ops), ts=db.clock)
