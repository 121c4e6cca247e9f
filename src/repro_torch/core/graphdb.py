"""GraphDB: the A1 database facade, read-only slice (§3).

Port of the read side of ``repro/core/graphdb.py``.  The host process plays
the coordinator: it owns the catalog, the global clock and the delta-fill
mirrors, and drives device work for everything data-touching.  This slice
has no write methods: a store comes from :meth:`GraphDB.from_numpy` (state
carried across from elsewhere) or from the loader in
:mod:`repro_torch.data.kg`.

Every database lives on one device, ``cuda`` unless the caller names
another; without a GPU the default raises instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import edges as edges_mod
from repro_torch.core import index as index_mod
from repro_torch.core.addressing import StoreConfig
from repro_torch.core.catalog import Catalog, EdgeType, VertexType
from repro_torch.core.store import (GraphStore, gather_data, make_store,
                                    store_from_numpy)


class CapacityError(RuntimeError):
    pass


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means ``cuda``, which raises
    when no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("GraphDB defaults to device='cuda' and no "
                               "CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class GraphDB:
    """One graph's storage and read path."""

    def __init__(self, cfg: StoreConfig, *, catalog: Optional[Catalog] = None,
                 tenant: str = "default", graph: str = "g",
                 backend: Optional[str] = None, device=None,
                 store: Optional[GraphStore] = None):
        cfg.validate()
        self.cfg = cfg
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
        self.dl_count = np.zeros(S, np.int64)        # delta-log fill mirrors
        self.il_count = np.zeros(S, np.int64)
        self.xd_count = np.zeros(S, np.int64)
        self._vindexed: set[int] = set()             # no vector index yet
        self.active_query_ts: list[int] = []         # pins for GC (§2.2)

    @classmethod
    def from_numpy(cls, cfg: StoreConfig, store_arrays: dict, schema,
                   counters: dict, *, device=None, backend=None) -> "GraphDB":
        """A database over carried-across state.

        ``store_arrays`` maps every ``GraphStore`` field to a numpy array;
        ``schema`` lists ``(kind, name, f_attrs, i_attrs)`` in creation order
        (kind ``"v"`` or ``"e"``), so type ids come out the same;
        ``counters`` holds the host mirrors ``clock``, ``dl_count``,
        ``il_count``, ``xd_count`` and ``v_next``."""
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

    def et(self, name: str) -> EdgeType:
        return self.catalog.proxy(self.tenant, self.graph, "e", name)

    def snapshot_ts(self) -> int:
        return self.clock

    # ------------------------------------------------------------------
    # queries (A1QL v2: the one entry point)
    # ------------------------------------------------------------------
    def query(self, queries: list[dict], **kw):
        """Execute a batch of A1QL queries (chains and star patterns); see
        :func:`repro_torch.core.query.engine.execute`.  Accepts ``caps=``,
        ``backend=``, ``read_ts=`` (scalar or per-query), ``parsed=``,
        ``fused=``, ``budget=``, ``deadline=``; returns a ``QueryResult``."""
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
        g, found = index_mod.lookup(
            self.store, self.cfg, self._i32([vt.type_id]),
            self._i32([int(key)]),
            torch.ones((1,), dtype=torch.bool, device=self.device), int(rts))
        return int(g[0]), bool(found[0])

    def get_vertex(self, vtype: str, key: int) -> Optional[dict]:
        vt = self.vt(vtype)
        gid, found = self.lookup_vertex(vtype, key)
        if not found:
            return None
        f, i, _ = gather_data(self.store, self.cfg, self._i32([gid]),
                              self.clock)
        f, i = f[0].cpu().numpy(), i[0].cpu().numpy()
        out = {"gid": gid, "key": key}
        for a in vt.attrs:
            out[a.name] = float(f[a.col]) if a.kind == "f32" else int(i[a.col])
        return out

    def get_edges(self, gid: int, *, direction: str = "out",
                  read_ts: Optional[int] = None, etype: int = -1,
                  cap: int = 4096) -> list[tuple[int, int]]:
        """Visible (neighbor, edge type) pairs of one vertex."""
        rts = self.clock if read_ts is None else read_ts
        _, n, v, ovf = edges_mod.expand(
            self.store, self.cfg, self._i32([0]), self._i32([gid]),
            torch.ones((1,), dtype=torch.bool, device=self.device),
            etype=int(etype), direction=direction, read_ts=int(rts),
            cap_out=cap)
        if bool(ovf):
            raise CapacityError("edge enumeration overflow; raise cap")
        types = self._expand_types(gid, direction, cap)
        return [(int(nbr), int(et)) for nbr, ok, et in
                zip(n.cpu().numpy(), v.cpu().numpy(), types) if ok]

    def _expand_types(self, gid: int, direction: str, cap: int):
        """Edge types aligned with expand()'s output layout."""
        st, cfg = self.store, self.cfg
        S, cap_v, cap_e = cfg.n_shards, cfg.cap_v, cfg.cap_e
        if direction == "out":
            indptr, typ, dslot, dtyp = (st.oe_indptr, st.oe_type, st.dl_slot,
                                        st.dl_type)
        else:
            indptr, typ, dslot, dtyp = (st.ie_indptr, st.ie_type, st.il_slot,
                                        st.il_type)
        sh, sl = gid % S, gid // S
        start = int(indptr[sh * (cap_v + 1) + sl]) + sh * cap_e
        k = torch.arange(cap, device=self.device)
        csr_t = typ[torch.clamp(start + k, max=S * cap_e - 1)]
        D = dslot.shape[0]
        d_shard = torch.arange(D, device=self.device) // cfg.cap_delta
        dt = torch.where(dslot * S + d_shard == gid, dtyp, -1)
        return torch.cat([csr_t, dt]).cpu().numpy()

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def gc_ts(self) -> int:
        """Records with delete_ts <= gc_ts are invisible to every running or
        future query, so they may be reclaimed (§2.2)."""
        return min(self.active_query_ts) if self.active_query_ts \
            else self.clock
