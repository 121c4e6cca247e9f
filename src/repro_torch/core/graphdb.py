"""GraphDB: the A1 database facade (data-plane + control-plane APIs, §3).

Port of ``repro/core/graphdb.py``.  The host process plays the coordinator:
it owns the catalog, the global clock, allocation metadata and the
delta-fill mirrors, and drives device work for everything data-touching.
Data-plane ops stage into :class:`~repro_torch.core.txn.Transaction`
objects and commit in batches through :meth:`GraphDB.write`
(``core/writes.py``); without a transaction each call runs under an
implicit one committed at once (§3).  A store can also be carried across
(:meth:`GraphDB.from_numpy`) or laid out by :mod:`repro_torch.data.kg`.

Not here yet: background compaction (``begin_compaction``,
``try_handoff``, ``vacuum``; an attached task queue raises) and the
replication log (ROADMAP queue 1, items 9 and 10).  The inline compactions
that the write wave's capacity backstop calls are here.

Every database lives on one device, ``cuda`` unless the caller names
another; without a GPU the default raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import collections
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import edges as edges_mod
from repro_torch.core import index as index_mod
from repro_torch.core import txn as txn_mod
from repro_torch.core import writes as writes_mod
from repro_torch.core.addressing import NULL, StoreConfig, gid_of
from repro_torch.core.backend import resolve_device
from repro_torch.core.catalog import Catalog, EdgeType, VertexType
from repro_torch.core.store import GraphStore, make_store, store_from_numpy
from repro_torch.core.writes import CapacityError  # noqa: F401  (re-export)

BACKGROUND_ITEM = "ROADMAP queue 1 item 9 (core/tasks.py)"
REPLICATION_ITEM = "ROADMAP queue 1 item 10 (core/replication.py)"


class GraphDB:
    """One graph's storage and transactional data plane."""

    def __init__(self, cfg: StoreConfig, *, catalog: Optional[Catalog] = None,
                 tenant: str = "default", graph: str = "g",
                 caps: Optional[txn_mod.BatchCaps] = None,
                 replication_log=None, backend: Optional[str] = None,
                 device=None, store: Optional[GraphStore] = None):
        cfg.validate()
        if replication_log is not None:
            raise NotImplementedError(
                f"replication_log is not ported yet: {REPLICATION_ITEM}")
        self.cfg = cfg
        self.caps = caps or txn_mod.BatchCaps()
        self.device = resolve_device(device)
        # read-path backend ('ref'|'kernel'|'auto'|None = env/auto), resolved
        # per query; host conveniences (lookup_vertex, get_edges) use 'ref'
        self.backend = backend
        self.store: GraphStore = (make_store(cfg, self.device) if store is None
                                  else store)
        if self.store.device != self.device:
            raise ValueError(f"store is on {self.store.device}, the database "
                             f"on {self.device}")
        self.catalog = catalog or Catalog()
        if tenant not in self.catalog.tenants:
            self.catalog.create_tenant(tenant)
        if graph not in self.catalog.tenants[tenant]:
            self.catalog.create_graph(tenant, graph)
        self.tenant, self.graph = tenant, graph
        # -- coordinator metadata (host-side) ---------------------------------
        S = cfg.n_shards
        self.clock: int = 1                          # FaRMv2 global clock
        self.v_next = np.zeros(S, np.int64)          # next fresh slot per shard
        self.v_free: list[list[int]] = [[] for _ in range(S)]   # vacuumed slots
        self._rr = 0                                 # round-robin shard cursor
        self.dl_count = np.zeros(S, np.int64)        # delta-log fill mirrors
        self.il_count = np.zeros(S, np.int64)
        self.xd_count = np.zeros(S, np.int64)
        self.vx_count = np.zeros(S, np.int64)        # vector-index fill mirror
        self._vindexed: set[int] = set()             # vector-indexed type_ids
        self._vx_pos: dict[int, tuple[int, int]] = {}  # gid -> (pos, type_id)
        self.replication_log = None                  # recovery hook (§4)
        self.stats = {"commits": 0, "aborts": 0, "compactions": 0,
                      "write_waves": 0, "vindex_compactions": 0}
        self.active_query_ts: list[int] = []         # pins for GC (§2.2)
        # -- compaction: structural epochs (a background shadow built at
        # epoch E may be handed off only while E holds), the task queue the
        # serving tier attaches, and the fill that schedules a compaction
        self.epochs = {"delete_e": 0, "delete_v": 0,
                       "compact_edges": 0, "compact_index": 0}
        self.task_queue = None
        self.compaction_watermark = 0.5
        # -- fleet replication (§4: primary-backup over committed waves) ---
        self.config_epoch = 0               # membership epoch last adopted
        self.wave_seq = 0                   # last wave applied here (frontier)
        self.wave_log: collections.deque = collections.deque(maxlen=512)
        self.applied_rids: collections.OrderedDict = collections.OrderedDict()
        self.fleet_pins: list[int] = []     # frontend-of-record snapshot pins

    @classmethod
    def from_numpy(cls, cfg: StoreConfig, store_arrays: dict, schema,
                   counters: dict, *, device=None,
                   backend=None) -> "GraphDB":
        """A database over carried-across state.

        ``store_arrays`` maps every ``GraphStore`` field to a numpy array;
        ``schema`` lists ``(kind, name, f_attrs, i_attrs)`` in creation order
        (kind ``"v"`` or ``"e"``), so type ids come out the same;
        ``counters`` holds the host mirrors ``clock``, ``dl_count``,
        ``il_count``, ``xd_count`` and ``v_next``; optionally the allocator's
        ``v_free`` (per-shard lists of vacuumed slots) and ``rr`` (its
        round-robin cursor) and the replication frontier ``wave_seq``, so a
        carried-across store allocates the gids its source would; and,
        where the store holds a vector index, ``vx_count``, ``vx_pos`` (gid
        -> (position, type_id)) and ``vindexed`` (the registered type ids),
        so the index carries across without a second backfill."""
        dev = resolve_device(device)
        db = cls(cfg, backend=backend, device=dev,
                 store=store_from_numpy(cfg, store_arrays, dev))
        for kind, name, f_attrs, i_attrs in schema:
            if kind == "v":
                db.vertex_type(name, f_attrs, i_attrs)
            else:
                db.edge_type(name)
        db.clock = int(counters["clock"])
        for k in ("dl_count", "il_count", "xd_count", "v_next"):
            setattr(db, k, np.asarray(counters[k], np.int64).copy())
        if "vx_count" in counters:
            db.vx_count = np.asarray(counters["vx_count"], np.int64).copy()
        db._vx_pos = {int(g): (int(p), int(t)) for g, (p, t) in
                      counters.get("vx_pos", {}).items()}
        db._vindexed = {int(t) for t in counters.get("vindexed", ())}
        if "v_free" in counters:
            db.v_free = [[int(x) for x in fr] for fr in counters["v_free"]]
        db._rr = int(counters.get("rr", 0))
        db.wave_seq = int(counters.get("wave_seq", 0))
        return db

    # ------------------------------------------------------------------
    # schema
    # ------------------------------------------------------------------
    def vertex_type(self, name: str, f_attrs=(), i_attrs=()) -> VertexType:
        return self.catalog.create_vertex_type(
            self.tenant, self.graph, name, f_attrs, i_attrs,
            max_f_cols=self.cfg.d_f32, max_i_cols=self.cfg.d_i32)

    def edge_type(self, name: str) -> EdgeType:
        return self.catalog.create_edge_type(self.tenant, self.graph, name)

    def vt(self, name: str) -> VertexType:
        return self.catalog.proxy(self.tenant, self.graph, "v", name)

    def vector_index(self, name: str) -> VertexType:
        """Register a vertex type for ``Nearest`` queries (``core/vindex``):
        its f32 payload row becomes its embedding, and the vertices alive
        now are backfilled."""
        from repro_torch.core import vindex as vindex_mod
        return vindex_mod.register(self, name)

    def et(self, name: str) -> EdgeType:
        return self.catalog.proxy(self.tenant, self.graph, "e", name)

    # ------------------------------------------------------------------
    # transactions
    # ------------------------------------------------------------------
    def create_transaction(self) -> txn_mod.Transaction:
        return txn_mod.Transaction(read_ts=self.clock)

    def snapshot_ts(self) -> int:
        return self.clock

    # ------------------------------------------------------------------
    # allocation (FaRM Alloc with locality hint)
    # ------------------------------------------------------------------
    def _alloc_vertex(self, hint_gid: Optional[int] = None) -> int:
        S = self.cfg.n_shards
        if hint_gid is not None and hint_gid >= 0:
            order = [int(hint_gid) % S] + [s for s in range(S)
                                           if s != int(hint_gid) % S]
        else:
            order = [(self._rr + i) % S for i in range(S)]
            self._rr = (self._rr + 1) % S
        for s in order:
            if self.v_free[s]:
                return gid_of(s, self.v_free[s].pop(), S)
            if self.v_next[s] < self.cfg.cap_v:
                slot = int(self.v_next[s])
                self.v_next[s] += 1
                return gid_of(s, slot, S)
        raise CapacityError("vertex store full on all shards")

    # ------------------------------------------------------------------
    # writes (the one entry point; per-op methods are staging wrappers)
    # ------------------------------------------------------------------
    def write(self, ops, *, txn=None, caps=None) -> writes_mod.WriteResult:
        """Execute a batch of mutations, the write twin of :meth:`query`.

        ``ops`` is either a list of mutation-op records
        (:class:`~repro_torch.core.writes.CreateVertex` et al.) or a list of
        staged :class:`~repro_torch.core.txn.Transaction` objects (never
        mixed):

        * op records + ``txn=``: stage into the open transaction, return
          per-op ``STAGED`` statuses and created gids positionally;
        * op records alone: one implicit atomic transaction, committed at
          once (§3);
        * transactions: one OCC-validation wave over all read sets, then
          the winners applied chunk by chunk; per-txn status and abort
          reason positionally.

        Staging contract violations (duplicate key, missing endpoint, ...)
        raise ``ValueError`` synchronously.  ``caps=`` overrides the
        per-chunk :class:`~repro_torch.core.txn.BatchCaps`."""
        return writes_mod.write(self, ops, txn=txn, caps=caps)

    def create_vertex(self, vtype: str, key: int, attrs: Optional[dict] = None,
                      txn: Optional[txn_mod.Transaction] = None,
                      hint: Optional[int] = None) -> int:
        return self.write([writes_mod.CreateVertex(vtype, int(key), attrs,
                                                   hint)], txn=txn).gids[0]

    def update_vertex(self, gid: int, vtype: str, attrs: dict,
                      txn: Optional[txn_mod.Transaction] = None) -> None:
        self.write([writes_mod.UpdateVertex(int(gid), vtype, attrs)], txn=txn)

    def delete_vertex(self, gid: int, txn: Optional[txn_mod.Transaction] = None
                      ) -> None:
        """Delete a vertex and all its half-edges (§3.2 cascade)."""
        self.write([writes_mod.DeleteVertex(int(gid))], txn=txn)

    def create_edge(self, src: int, dst: int, etype: str,
                    txn: Optional[txn_mod.Transaction] = None,
                    check: bool = True) -> None:
        """``check=False`` skips the endpoint and duplicate reads: the bulk
        load's fast path, where uniqueness is the loader's contract."""
        self.write([writes_mod.CreateEdge(int(src), int(dst), etype, check)],
                   txn=txn)

    def delete_edge(self, src: int, dst: int, etype: str,
                    txn: Optional[txn_mod.Transaction] = None) -> None:
        self.write([writes_mod.DeleteEdge(int(src), int(dst), etype)],
                   txn=txn)

    # -- deprecated shims (the wave lives in core/writes.py) ---------------
    def commit(self, txn: txn_mod.Transaction) -> str:
        """Deprecated: use ``write([txn])``."""
        warnings.warn(
            "GraphDB.commit is deprecated; use GraphDB.write([txn])",
            DeprecationWarning, stacklevel=2)
        return self.write([txn]).statuses[0]

    def commit_many(self, txns: Sequence[txn_mod.Transaction]) -> list[str]:
        """Deprecated: use ``write(txns)``.  Returns per-txn status."""
        warnings.warn(
            "GraphDB.commit_many is deprecated; use GraphDB.write(txns)",
            DeprecationWarning, stacklevel=2)
        txns = list(txns)
        if not txns:
            return []
        return self.write(txns).statuses

    # ------------------------------------------------------------------
    # queries (A1QL v2: the one entry point)
    # ------------------------------------------------------------------
    def query(self, queries: list[dict], **kw):
        """Execute a batch of A1QL queries (chains and star patterns); see
        :func:`repro_torch.core.query.engine.execute`.  Accepts ``caps=``,
        ``backend=``, ``read_ts=`` (scalar or per-query), ``mesh=`` (a
        ``repro_torch.dist.mesh.make_mesh(cfg.n_shards, device=...)``: the
        SPMD query-shipping programs, one shard a mesh slot), ``parsed=``,
        ``fused=``, ``budget=``, ``deadline=``; returns a ``QueryResult``.
        ``planner.FRONTIER_STATS`` and ``OVERFLOW_STATS`` count mesh runs
        as they count local ones."""
        from repro_torch.core.query.engine import execute
        return execute(self, queries, **kw)

    # ------------------------------------------------------------------
    # reads (host conveniences; bulk reads go through the query engine)
    # ------------------------------------------------------------------
    def _i32(self, xs):
        return torch.tensor(xs, dtype=torch.int32, device=self.device)

    def lookup_vertex(self, vtype: str, key: int,
                      read_ts: Optional[int] = None) -> tuple[int, bool]:
        vt = self.vt(vtype)
        rts = self.clock if read_ts is None else read_ts
        g, _ = index_mod.lookup(
            self.store, self.cfg, self._i32([vt.type_id]),
            self._i32([int(key)]),
            torch.ones((1,), dtype=torch.bool, device=self.device), int(rts))
        g = int(g[0])
        return g, g >= 0

    def get_vertex(self, vtype: str, key: int) -> Optional[dict]:
        vt = self.vt(vtype)
        gid, found = self.lookup_vertex(vtype, key)
        if not found:
            return None
        f, i = self._read_data_host(gid, self.clock)
        out = {"gid": gid, "key": key}
        for a in vt.attrs:
            out[a.name] = float(f[a.col]) if a.kind == "f32" else int(i[a.col])
        return out

    def get_edges(self, gid: int, *, direction: str = "out",
                  read_ts: Optional[int] = None, etype: int = -1,
                  cap: int = 4096) -> list[tuple[int, int]]:
        """Visible (neighbor, edge type) pairs of one vertex, in the order
        ``edges.expand`` lays them out: its CSR span, then its delta-log
        entries in log order.  A span longer than ``cap`` raises (expand's
        overflow).  Two copies to the host: the span's bounds, then the
        span and the shard's filled log prefix (the logs fill prefix-first,
        and ``dl_count`` / ``il_count`` mirror the fill)."""
        rts = self.clock if read_ts is None else int(read_ts)
        cfg = self.cfg
        sh, sl = gid % cfg.n_shards, gid // cfg.n_shards
        indptr, *pool = edges_mod._csr_arrays(self.store, direction)
        p = sh * (cfg.cap_v + 1) + sl
        lo, hi = indptr[p:p + 2].tolist()
        if hi - lo > cap:
            raise CapacityError("edge enumeration overflow; raise cap")
        a, n = sh * cfg.cap_e + lo, hi - lo
        c = sh * cfg.cap_delta
        fill = int((self.dl_count if direction == "out"
                    else self.il_count)[sh])
        x = torch.cat([t[a:a + n] for t in pool] + [
            t[c:c + fill] for t in edges_mod._delta_arrays(self.store,
                                                           direction)]
                      ).cpu().numpy()
        nbr, typ, cre, dele = x[:4 * n].reshape(4, n)
        slot, dnbr, dtyp, dcre, ddel = x[4 * n:].reshape(5, fill)

        def ok(t, nb, c0, d0):
            return ((c0 <= rts) & (rts < d0) & (nb >= 0)
                    & ((t == etype) if etype >= 0 else True))
        m, md = ok(typ, nbr, cre, dele), (slot == sl) & ok(dtyp, dnbr, dcre,
                                                            ddel)
        return [(int(v), int(t)) for v, t in zip(
            np.concatenate([nbr[m], dnbr[md]]),
            np.concatenate([typ[m], dtyp[md]]))]

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def gc_ts(self) -> int:
        """Records with delete_ts <= gc_ts are invisible to every running or
        future query (visibility is ``rts < delete_ts``), so they may be
        reclaimed (§2.2).  Both the local pins and the fleet's count: in a
        cluster the frontend pins the snapshots its clients still page."""
        pins = list(self.active_query_ts) + list(self.fleet_pins)
        return min(pins) if pins else self.clock

    def run_compaction(self) -> None:
        """Inline (stop-the-world) edge compaction: the overflow backstop."""
        self.store = edges_mod.compact(self.store, self.cfg, self.gc_ts())
        self.dl_count[:] = 0
        self.il_count[:] = 0
        self.stats["compactions"] += 1
        self.epochs["compact_edges"] += 1

    def run_index_compaction(self) -> None:
        self.store = index_mod.compact_index(self.store, self.cfg,
                                             self.gc_ts())
        self.xd_count[:] = 0
        self.epochs["compact_index"] += 1

    def run_vindex_compaction(self) -> None:
        """Fold the vector index: age out entries dead before gc_ts."""
        from repro_torch.core import vindex as vindex_mod
        vindex_mod.run_compaction(self)

    def _kinds_needed(self) -> list:
        """Compaction kinds whose delta fill crossed the watermark."""
        kinds = []
        wm = self.compaction_watermark
        fill = max(self.dl_count.max(initial=0), self.il_count.max(initial=0))
        if fill >= wm * self.cfg.cap_delta:
            kinds.append("edges")
        if self.xd_count.max(initial=0) >= wm * self.cfg.cap_idx_delta:
            kinds.append("index")
        if (self._vindexed
                and self.vx_count.max(initial=0) >= wm * self.cfg.cap_vec):
            kinds.append("vindex")
        return kinds

    def _maybe_schedule_compaction(self) -> None:
        """Called after every write wave: with a task queue attached,
        crossing the watermark schedules the background compaction; without
        one, the inline overflow backstop alone guarantees capacity."""
        if self.task_queue is None:
            return
        if self._kinds_needed():
            raise NotImplementedError(
                f"background compaction is not ported yet: {BACKGROUND_ITEM}")

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _txn(self, txn):
        if txn is None:
            return self.create_transaction(), True
        if txn.status != "OPEN":
            raise txn_mod.Aborted(f"transaction is {txn.status}")
        return txn, False

    def _encode_attrs(self, vt: VertexType, attrs: dict,
                      base_f=None, base_i=None):
        f = np.zeros(self.cfg.d_f32, np.float32) if base_f is None \
            else np.array(base_f, np.float32)
        i = np.zeros(self.cfg.d_i32, np.int32) if base_i is None \
            else np.array(base_i, np.int32)
        for name, val in attrs.items():
            a = vt.attr(name)
            if a.kind == "f32":
                f[a.col] = float(val)
            else:
                i[a.col] = int(val)
        return f, i

    def _row(self, gid: int) -> int:
        """The vertex row of a gid (a negative gid reads row 0, a row past
        the store its last, as the JAX gathers clamp)."""
        S = self.cfg.n_shards
        g = max(int(gid), 0)
        return min((g % S) * self.cfg.cap_v + g // S, S * self.cfg.cap_v - 1)

    def _read_header_host(self, gid: int, rts: int):
        """(vtype, key, alive) of one vertex at ``rts`` (``gather_headers``
        of one gid): one gather, one copy to the host."""
        st, r = self.store, self._row(gid)
        vt, key, cre, dele = torch.cat([
            a[r:r + 1] for a in (st.vtype, st.vkey, st.v_create,
                                 st.v_delete)]).tolist()
        if gid >= 0 and cre <= rts < dele:
            return vt, key, True
        return int(NULL), int(NULL), False

    def _read_data_host(self, gid: int, rts: int):
        """(f32 row, i32 row) of one vertex at ``rts`` (``gather_data`` of
        one gid: the current or previous version, times the visibility), as
        numpy arrays: one gather, one copy to the host."""
        st, r = self.store, self._row(gid)
        df, di = self.cfg.d_f32, self.cfg.d_i32
        a = torch.cat([st.vdata_f[r].view(torch.int32),
                       st.vprev_f[r].view(torch.int32), st.vdata_i[r],
                       st.vprev_i[r]] + [x[r:r + 1] for x in (
                           st.vdata_ts, st.v_create, st.v_delete)]
                      ).cpu().numpy()
        dts, cre, dele = (int(x) for x in a[-3:])
        cur = dts <= rts
        f = a[:df] if cur else a[df:2 * df]
        i = a[2 * df:2 * df + di] if cur else a[2 * df + di:2 * df + 2 * di]
        alive = gid >= 0 and cre <= rts < dele
        return (f.view(np.float32) * np.float32(alive),
                i * np.int32(alive))
