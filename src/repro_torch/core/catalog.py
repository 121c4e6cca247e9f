"""Catalog: tenants / graphs / types / schemas + proxy cache (§3, §3.1).

The paper's catalog is a FaRM-resident KV store mapping names to the root
pointers of data structures, fronted by a TTL'd in-memory *proxy* cache so
data-plane calls don't pay repeated remote reads.  Here the control plane runs
on the host (the coordinator): the catalog is host state, checkpointed with
the store, and the proxy cache reproduces the TTL/refresh behavior (it's also
what makes repeated data-plane calls cheap — schema resolution is pure host
metadata, no device work).

Schema model (Bond analogue): a vertex type declares typed attribute columns
('f32' or 'i32') mapped onto contiguous column ranges of the store's
``vdata_f`` / ``vdata_i`` matrices, plus a mandatory int primary key.  String
attributes are dictionary-encoded to i32 by the data pipeline (noted in
DESIGN.md: TPU stores numbers, the dictionary lives with the loader).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AttrDef:
    name: str
    kind: str            # 'f32' | 'i32'
    col: int             # column index within the store matrix


@dataclasses.dataclass(frozen=True)
class VertexType:
    name: str
    type_id: int
    attrs: tuple[AttrDef, ...]
    primary_key: str = "key"     # implicit i32 key column (store.vkey)

    def attr(self, name: str) -> AttrDef:
        for a in self.attrs:
            if a.name == name:
                return a
        raise KeyError(f"vertex type {self.name!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class EdgeType:
    name: str
    type_id: int
    attrs: tuple[AttrDef, ...] = ()


class _Proxy:
    """TTL'd cached handle to a catalog object (§3.1)."""

    __slots__ = ("obj", "version", "expires")

    def __init__(self, obj, version, ttl, now):
        self.obj, self.version, self.expires = obj, version, now + ttl


@dataclasses.dataclass
class GraphMeta:
    name: str
    state: str = "Active"            # Active | Deleting  (async delete, §3.3)
    vtypes: dict = dataclasses.field(default_factory=dict)
    etypes: dict = dataclasses.field(default_factory=dict)
    next_vtype: int = 0
    next_etype: int = 0
    f_cols_used: int = 0
    i_cols_used: int = 0


class Catalog:
    """Host-side control plane: tenant -> graph -> types."""

    def __init__(self, *, proxy_ttl: float = 60.0, clock=time.monotonic):
        self.tenants: dict[str, dict[str, GraphMeta]] = {}
        self.version = 0                     # bumped on every control-plane op
        self._proxies: dict[tuple, _Proxy] = {}
        self._ttl = proxy_ttl
        self._clock = clock

    # -- control plane (each op runs under its own implicit txn, §3) ---------
    def create_tenant(self, tenant: str) -> None:
        if tenant in self.tenants:
            raise ValueError(f"tenant {tenant!r} exists")
        self.tenants[tenant] = {}
        self.version += 1

    def create_graph(self, tenant: str, graph: str) -> GraphMeta:
        graphs = self.tenants.setdefault(tenant, {})
        if graph in graphs:
            raise ValueError(f"graph {graph!r} exists")
        graphs[graph] = GraphMeta(name=graph)
        self.version += 1
        return graphs[graph]

    def get_graph(self, tenant: str, graph: str) -> GraphMeta:
        g = self.tenants[tenant][graph]
        if g.state != "Active":
            raise ValueError(f"graph {graph!r} is {g.state}")
        return g

    def mark_deleting(self, tenant: str, graph: str) -> GraphMeta:
        g = self.tenants[tenant][graph]
        g.state = "Deleting"
        self.version += 1
        return g

    def drop_graph(self, tenant: str, graph: str) -> None:
        del self.tenants[tenant][graph]
        self.version += 1

    def create_vertex_type(self, tenant: str, graph: str, name: str,
                           f_attrs=(), i_attrs=(), *,
                           max_f_cols: int, max_i_cols: int) -> VertexType:
        g = self.get_graph(tenant, graph)
        if name in g.vtypes:
            raise ValueError(f"vertex type {name!r} exists")
        # column ranges are per-type: a vertex row has exactly one type, so
        # different types reuse the same physical columns (columnar Bond).
        attrs = []
        for col, a in enumerate(f_attrs):
            if col >= max_f_cols:
                raise ValueError("out of f32 attribute columns")
            attrs.append(AttrDef(a, "f32", col))
        for col, a in enumerate(i_attrs):
            if col >= max_i_cols:
                raise ValueError("out of i32 attribute columns")
            attrs.append(AttrDef(a, "i32", col))
        g.f_cols_used = max(g.f_cols_used, len(f_attrs))
        g.i_cols_used = max(g.i_cols_used, len(i_attrs))
        vt = VertexType(name=name, type_id=g.next_vtype, attrs=tuple(attrs))
        g.next_vtype += 1
        g.vtypes[name] = vt
        self.version += 1
        return vt

    def create_edge_type(self, tenant: str, graph: str, name: str) -> EdgeType:
        g = self.get_graph(tenant, graph)
        if name in g.etypes:
            raise ValueError(f"edge type {name!r} exists")
        et = EdgeType(name=name, type_id=g.next_etype)
        g.next_etype += 1
        g.etypes[name] = et
        self.version += 1
        return et

    # -- proxy cache (data plane resolution, §3.1) ----------------------------
    def proxy(self, tenant: str, graph: str, kind: str, name: str):
        """Resolve a type by name through the TTL'd proxy cache."""
        key = (tenant, graph, kind, name)
        now = self._clock()
        p = self._proxies.get(key)
        if p is not None:
            if now < p.expires:
                return p.obj
            if p.version == self.version:      # unchanged: extend the TTL
                p.expires = now + self._ttl
                return p.obj
        g = self.get_graph(tenant, graph)
        obj = (g.vtypes if kind == "v" else g.etypes)[name]
        self._proxies[key] = _Proxy(obj, self.version, self._ttl, now)
        return obj

    def invalidate_proxies(self) -> None:
        self._proxies.clear()
