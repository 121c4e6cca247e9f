"""Recovery from the ObjectStore (§4) and fast restart (§5.3).

Port of ``repro/core/recovery.py``.  Two recovery modes, the paper's
semantics:

* **consistent**: rebuild from the versioned tables at the durable
  watermark t_R, the most recent transactionally consistent snapshot.  A
  partially replicated transaction (some entries above t_R unshipped) is
  excluded wholesale.
* **best-effort**: rebuild from the LWW tables (every vertex and edge that
  reached durable storage, whatever the transaction boundaries), then
  repair internal consistency: an edge whose endpoint is missing is
  dropped.  Always at least as fresh as consistent recovery.

Both load through the port's write path onto ``device``.

Fast restart: the store lives in a process-external holder (the paper's
PyCo region; a host-RAM cache object here).  A restarted serving
process re-attaches the tensors instead of reloading from durable storage.
The port writes its store in place, so every hand-over copies: ``hold``
copies the store to the host, ``restart`` and ``attach_shared`` give each
database tensors of its own, and one database's writes never reach another
or the held copy.

Every entry point that makes a database takes ``device=`` (``cuda`` by
default, which raises without a GPU).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import txn as txn_mod
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.graphdb import GraphDB
from repro_torch.core.replication import TOMBSTONE, ObjectStore
from repro_torch.core.store import FIELDS, GraphStore


# ---------------------------------------------------------------------------
# rebuild helpers
# ---------------------------------------------------------------------------

def _rebuild(db: GraphDB, vrows: dict, erows: dict, *,
             drop_dangling: bool) -> GraphDB:
    """Load logical rows through the transactional write path."""
    from repro_torch.core.writes import CreateEdge, CreateVertex
    meta = db.catalog.tenants[db.tenant][db.graph]
    id2name = {vt.type_id: name for name, vt in meta.vtypes.items()}
    e2name = {et.type_id: name for name, et in meta.etypes.items()}

    def load(ops, chunk):
        gids = []
        for off in range(0, len(ops), chunk):
            res = db.write(ops[off:off + chunk])
            assert not res.failed
            gids += res.gids
        return gids

    v_ops, v_keys = [], []
    for (vtid, key), (val, ts) in sorted(vrows.items()):
        if val == TOMBSTONE:
            continue
        f, i = val
        name = id2name[vtid]
        attrs = {a.name: (f[a.col] if a.kind == "f32" else i[a.col])
                 for a in db.vt(name).attrs}
        v_ops.append(CreateVertex(name, key, attrs))
        v_keys.append((vtid, key))
    gid_of = dict(zip(v_keys, load(v_ops, 200)))

    e_ops = []
    for ekey, (val, ts) in sorted(erows.items()):
        if val == TOMBSTONE:
            continue
        svt, sk, et, dvt, dk = ekey
        s = gid_of.get((svt, sk))
        d = gid_of.get((dvt, dk))
        if s is None or d is None:
            if drop_dangling:
                continue                  # internal consistency repair
            raise ValueError(f"dangling edge {ekey} in consistent recovery")
        # endpoints were just validated against the recovered row set: the
        # bulk-load fast path applies, like the original apply stream
        e_ops.append(CreateEdge(s, d, e2name[int(et)], check=False))
    load(e_ops, 400)
    db.run_compaction()
    db.run_index_compaction()
    return db


def _clone_schema(src_db: GraphDB, cfg: StoreConfig, device) -> GraphDB:
    db = GraphDB(cfg, device=device)
    meta = src_db.catalog.tenants[src_db.tenant][src_db.graph]
    for name, vt in meta.vtypes.items():
        f = [a.name for a in vt.attrs if a.kind == "f32"]
        i = [a.name for a in vt.attrs if a.kind == "i32"]
        db.vertex_type(name, f, i)
    for name in meta.etypes:
        db.edge_type(name)
    return db


def best_effort_recover(store: ObjectStore, schema_db: GraphDB,
                        cfg: StoreConfig, *, graph: str = "g",
                        device=None) -> GraphDB:
    """LWW tables -> fresh GraphDB on ``device``; dangling edges dropped."""
    db = _clone_schema(schema_db, cfg, resolve_device(device))
    vrows = store.scan(f"{graph}.vertices")
    erows = store.scan(f"{graph}.edges")
    return _rebuild(db, vrows, erows, drop_dangling=True)


def consistent_recover(store: ObjectStore, schema_db: GraphDB,
                       cfg: StoreConfig, *, graph: str = "g",
                       device=None) -> GraphDB:
    """Versioned tables filtered at t_R -> a transactionally consistent
    GraphDB on ``device``."""
    t_r = store.get_meta(f"{graph}.t_R", 0)
    vrows: dict = {}
    for (vt, key, ts), (val, _) in store.scan(
            f"{graph}.vertices.versions").items():
        if ts > t_r:
            continue
        cur = vrows.get((vt, key))
        if cur is None or ts >= cur[1]:
            vrows[(vt, key)] = (val, ts)
    erows: dict = {}
    for row, (val, _) in store.scan(f"{graph}.edges.versions").items():
        *ekey, ts = row
        if ts > t_r:
            continue
        ekey = tuple(ekey)
        cur = erows.get(ekey)
        if cur is None or ts >= cur[1]:
            erows[ekey] = (val, ts)
    db = _clone_schema(schema_db, cfg, resolve_device(device))
    return _rebuild(db, vrows, erows, drop_dangling=False)


# ---------------------------------------------------------------------------
# fast restart (§5.3)
# ---------------------------------------------------------------------------

def _store_on(arrays: dict, device) -> GraphStore:
    """A store of fresh tensors on ``device`` copied from host arrays (a
    copy on the CPU too: the source may be a held slot or shared pages)."""
    return GraphStore(**{f: torch.as_tensor(arrays[f]).to(device, copy=True)
                         for f in FIELDS})


def _wire_db(s: dict, store: GraphStore) -> GraphDB:
    """Wire a fresh GraphDB around a materialized store plus the held
    coordinator state (the common core of :meth:`FastRestartCache.restart`
    and :func:`attach_shared`)."""
    db = GraphDB.__new__(GraphDB)
    db.cfg = s["cfg"]
    db.caps = txn_mod.BatchCaps()
    db.device = store.device
    db.backend = None
    db.store = store
    db.catalog = s["catalog"]
    db.tenant, db.graph = "default", "g"
    db._init_coordinator()
    db.clock = s["clock"]
    db.v_next = s["v_next"].copy()
    db.v_free = [list(x) for x in s["v_free"]]
    db.dl_count = s["dl_count"].copy()
    db.il_count = s["il_count"].copy()
    db.xd_count = s["xd_count"].copy()
    # the vector-index slots live inside the held store; only the host
    # mirrors need re-attaching
    db.vx_count = s["vx_count"].copy()
    db._vindexed = set(s["vindexed"])
    db._vx_pos = dict(s["vx_pos"])
    db.wave_seq = int(s["wave_seq"])
    db.applied_rids = collections.OrderedDict(
        (k, dict(v)) for k, v in dict(s["applied_rids"]).items())
    return db


def _shm_attach(name: str):
    """Map an exporter's shared-memory segment without registering it
    with the resource tracker, which would unlink it at exit: only the
    exporter owns its lifetime.  Python 3.13 has ``track=False``; before
    it, the registration is skipped.  (A spawned worker shares its
    parent's tracker, so registering and unregistering there would strike
    the exporter's own registration.)"""
    from multiprocessing import resource_tracker, shared_memory
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:
        register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = register


@contextlib.contextmanager
def _populated(shm, *, writable: bool):
    """A second mapping of a segment's pages, populated as it is made
    (``MAP_POPULATE``): one call maps every page where the segment's own
    mapping faults them in one by one."""
    import mmap
    prot = mmap.PROT_READ | (mmap.PROT_WRITE if writable else 0)
    pages = mmap.mmap(shm._fd, shm.size, prot=prot, flags=mmap.MAP_SHARED
                      | getattr(mmap, "MAP_POPULATE", 0))
    try:
        yield pages
    finally:
        try:
            pages.close()
        except BufferError:
            pass        # views outlive an error; the mapping goes with them


def attach_shared(manifest: dict, *, device=None) -> GraphDB:
    """Re-attach a serving process to an :meth:`export_shared` segment.

    The worker maps the exporter's shared pages and copies each field onto
    ``device`` (one host-to-device copy a field on the card, the §5.3
    re-attach cost; a copy on the CPU too), so one worker's in-place writes
    never reach a sibling or the segment, the one host copy of record.  The
    mapping is closed once the fields are copied; the exporter owns
    unlinking (:meth:`FastRestartCache.drop`)."""
    import warnings
    dev = resolve_device(device)
    shm = _shm_attach(manifest["segment"])
    try:
        # a read-only mapping of the same pages, populated as it is made:
        # the copies onto the card read it several times faster than the
        # segment's own read-write mapping, whose pages fault in one by one
        with _populated(shm, writable=False) as pages:
            arrays = {fname: np.ndarray(shape, dtype=np.dtype(dtype),
                                        buffer=pages, offset=off)
                      for fname, (off, shape, dtype)
                      in manifest["fields"].items()}
            with warnings.catch_warnings():
                # read-only views, copied at once: nothing writes through
                warnings.filterwarnings("ignore", message=".*not writable")
                store = _store_on(arrays, dev)
            del arrays
    finally:
        shm.close()
    return _wire_db(manifest["meta"], store)


class FastRestartCache:
    """Process-external region holder (the paper's PyCo analogue).

    Keeps a host copy of the store plus the coordinator state.  A restarted
    process re-attaches with one copy to the device instead of replaying
    durable storage.  It does not survive a host power cycle: that is the
    disaster-recovery path's job, as in the paper."""

    def __init__(self):
        self._slots: dict = {}
        self._shm: dict = {}             # name -> exported SharedMemory

    def hold(self, name: str, db: GraphDB) -> None:
        """Copy ``db``'s store to host arrays of their own (on the CPU a
        tensor's ``numpy()`` would share the live store's memory, which
        later in-place waves write) and its coordinator state."""
        self._slots[name] = dict(
            store={f: getattr(db.store, f).to("cpu", copy=True).numpy()
                   for f in FIELDS},
            clock=db.clock,
            v_next=db.v_next.copy(),
            v_free=[list(x) for x in db.v_free],
            dl_count=db.dl_count.copy(),
            il_count=db.il_count.copy(),
            xd_count=db.xd_count.copy(),
            vx_count=db.vx_count.copy(),
            vindexed=set(db._vindexed),
            vx_pos=dict(db._vx_pos),
            catalog=db.catalog,
            cfg=db.cfg,
            wave_seq=int(db.wave_seq),
            applied_rids={k: dict(v) for k, v in db.applied_rids.items()},
        )

    def restart(self, name: str, *, device=None) -> Optional[GraphDB]:
        """Re-attach: a fresh GraphDB on ``device`` with tensors of its own,
        copied from the held slot; ``None`` when the slot is gone (the
        caller falls back to disaster recovery)."""
        s = self._slots.get(name)
        if s is None:
            return None
        return _wire_db(s, _store_on(s["store"], resolve_device(device)))

    def export_shared(self, name: str) -> dict:
        """Publish a held slot as ONE POSIX shared-memory segment.

        The exporting frontend keeps the single host copy of the store;
        each worker :func:`attach_shared`-maps the same pages and pays only
        its own device copy.  Returns a picklable manifest (segment name,
        per-field offset / shape / dtype, the coordinator state).  The
        segment lives until :meth:`drop` (or exporter exit) unlinks it."""
        from multiprocessing import shared_memory
        s = self._slots[name]
        if name in self._shm:
            raise ValueError(f"slot {name!r} already exported")
        arrs = {f: np.ascontiguousarray(s["store"][f]) for f in FIELDS}
        fields, off = {}, 0
        for fname, a in arrs.items():
            off = (off + 63) & ~63                   # 64B-align each field
            fields[fname] = (off, a.shape, a.dtype.str)
            off += a.nbytes
        shm = shared_memory.SharedMemory(create=True, size=max(off, 1))
        with _populated(shm, writable=True) as pages:
            for fname, a in arrs.items():
                np.ndarray(a.shape, dtype=a.dtype, buffer=pages,
                           offset=fields[fname][0])[...] = a
        self._shm[name] = shm
        meta = {k: v for k, v in s.items() if k != "store"}
        return {"segment": shm.name, "fields": fields, "meta": meta}

    def drop(self, name: str) -> None:
        self._slots.pop(name, None)
        shm = self._shm.pop(name, None)
        if shm is not None:
            shm.close()
            shm.unlink()
