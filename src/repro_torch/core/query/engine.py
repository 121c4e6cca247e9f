"""A1QL v2: the unified query entry point (§3.4).

Port of ``repro/core/query/engine.py``: :func:`execute`, exported as
``GraphDB.query``.  Every query parses to the typed logical-plan IR and
routing is internal:

  * **uniform** batches (one physical plan, one set of cap hints, one
    snapshot) run the per-plan executor, whose §3.4 working-set budget is
    shared by the batch — the parity oracle;
  * everything else — mixed plan shapes, stars next to chains, per-query
    snapshots, cap hints, gid cursors, a deadline — runs the fused waves of
    :mod:`repro_torch.core.query.planner` with per-query budgets.
    ``fused=True`` forces that path (per-query ``failed_q`` flags even for a
    uniform batch, as the serving tier calls it); ``fused=False`` forbids it.

``budget="shared"`` pools every live query's frontier into one shared
pool (``planner_shared``) and always runs fused; ``Nearest``-rooted plans
exist only as fused k-NN probe waves, so they run fused too.

``mesh=`` (a :class:`repro_torch.dist.mesh.ShardMesh` of ``cfg.n_shards``
shards) runs the SPMD programs of each path instead (the §3.4 query
shipping of ``executor_spmd`` and the planners), with the same results;
their select rows are ordered shard-major, so a gid cursor under ``mesh=``
raises.  The mesh's shard order is the row-major order of the JAX
package's ``("data", "model")`` axes, so there is no ``storage_axes``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core.query import ir
from repro_torch.core.query.a1ql import parse
from repro_torch.core.query.executor import (QueryCaps, QueryResult,
                                             _to_result, compile_query)


def _normalize_parsed(db, queries, parsed) -> list[ir.Lowered]:
    if parsed is None:
        return [ir.lower(parse(db, q)) for q in queries]
    out = []
    for p in parsed:
        if isinstance(p, ir.Lowered):
            out.append(p)
        elif ir.is_root(p):
            out.append(ir.lower(p))
        elif isinstance(p, tuple) and len(p) == 2:
            out.append(ir.from_legacy(*p))       # historical (plan, key)
        else:
            raise TypeError(f"bad parsed entry {type(p).__name__}")
    if len(out) != len(queries):
        raise ValueError(f"{len(out)} parsed entries for "
                         f"{len(queries)} queries")
    return out


def _normalize_ts(db, Q: int,
                  read_ts: Union[None, int, Sequence[int]]) -> list[int]:
    if read_ts is None:
        return [db.snapshot_ts()] * Q
    if isinstance(read_ts, (int, np.integer)):
        return [int(read_ts)] * Q
    ts = [int(t) for t in read_ts]
    if len(ts) != Q:
        raise ValueError(f"read_ts has {len(ts)} entries for {Q} queries")
    return ts


def execute(db, queries: list[dict], *, caps: Optional[QueryCaps] = None,
            backend: Optional[str] = None,
            read_ts: Union[None, int, Sequence[int]] = None,
            mesh=None, parsed: Optional[list] = None,
            fused: Optional[bool] = None,
            budget: Optional[str] = None,
            deadline: Optional[float] = None) -> QueryResult:
    """Execute a batch of A1QL queries at consistent snapshot timestamps.

    See the module docstring for routing.  Every distinct snapshot is pinned
    for the call (``db.active_query_ts``, the §2.2 GC barrier), and results
    scatter back into input order.  Documents may carry a root-level
    ``"gid_cursor"`` (a runtime final predicate ``gid > cursor``); cursor
    batches run fused.  ``deadline`` is an absolute ``time.monotonic()``
    instant: fusion groups past it are skipped and flagged ``deadline_q``.
    ``mesh`` is a ``ShardMesh`` with one shard per store shard.
    """
    from repro_torch.core import faults as faults_mod
    from repro_torch.core.query import planner
    from repro_torch.dist.mesh import ShardMesh
    if not queries:
        raise ValueError("execute() needs at least one query")
    # chaos site: a wave-execution crash ("raise") or straggler ("stall"),
    # before any snapshot is pinned
    faults_mod.check(db, "engine.wave")
    if budget not in (None, "per-query", "shared"):
        raise ValueError(f"budget must be 'per-query' or 'shared', "
                         f"got {budget!r}")
    if mesh is not None:
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"mesh= takes a repro_torch.dist.mesh.ShardMesh, "
                            f"got {type(mesh).__name__}")
        if mesh.size != db.cfg.n_shards:
            raise ValueError(f"a mesh of {mesh.size} shards over a store of "
                             f"{db.cfg.n_shards}: one shard a mesh slot")
    caps = caps or QueryCaps()
    be = backend_mod.resolve(backend or getattr(db, "backend", None))
    lowered = _normalize_parsed(db, queries, parsed)
    Q = len(lowered)
    ts_list = _normalize_ts(db, Q, read_ts)
    eff_caps = [lo.hints.apply(caps) for lo in lowered]
    cursors = [lo.cursor for lo in lowered]
    any_cursor = any(c >= 0 for c in cursors)
    if any_cursor and mesh is not None:
        # SPMD select rows are shard-major, not gid-ascending: paging by a
        # max-gid cursor could skip rows on later shards for good
        raise ValueError("gid_cursor is not supported under mesh= "
                         "(SPMD rows are shard-major; use the growing-"
                         "window continuation instead)")
    # Nearest-rooted plans exist only as fused probe-wave rows (the
    # per-plan executor has no k-NN wave)
    any_nearest = any(p.nearest_k > 0 for lo in lowered
                      for p in lo.plan.chain_units())
    uniform = (all(lo.plan == lowered[0].plan for lo in lowered[1:])
               and all(c == eff_caps[0] for c in eff_caps[1:])
               and len(set(ts_list)) == 1
               and not any_cursor
               and not any_nearest)
    if fused is False and not uniform:
        raise ValueError("fused=False requires a uniform batch "
                         "(one plan shape, caps, snapshot, no cursors, "
                         "no nearest)")
    if fused is False and budget == "shared":
        raise ValueError("budget='shared' requires the fused planner")
    if fused is False and deadline is not None:
        raise ValueError("deadline= requires the fused planner (the "
                         "uniform executor has no per-group skip point)")
    run_fused = (bool(fused) or not uniform or budget == "shared"
                 or deadline is not None)

    pins = sorted(set(ts_list))
    for t in pins:                            # pin versions (GC barrier)
        db.active_query_ts.append(t)
    try:
        if run_fused:
            return planner.execute_fused(db, lowered, eff_caps, ts_list, be,
                                         mesh=mesh,
                                         budget=budget or "per-query",
                                         cursors=cursors, deadline=deadline)
        return _execute_uniform(db, lowered, eff_caps[0], ts_list[0], be,
                                mesh)
    finally:
        for t in pins:
            db.active_query_ts.remove(t)


def _execute_uniform(db, lowered: list[ir.Lowered], caps: QueryCaps,
                     read_ts: int, be, mesh=None) -> QueryResult:
    """One plan shape, shared working-set budget: the per-plan executors."""
    from repro_torch.core.query.planner import index_window
    plan = lowered[0].plan
    Q = len(lowered)
    if plan.is_intersect:
        # (branches, Q) key layout: branch bi of query qi probes keys[bi, qi]
        keys = [[lo.keys[bi] for lo in lowered]
                for bi in range(len(plan.branches))]
    else:
        keys = [lo.keys[0] for lo in lowered]
    keys = torch.tensor(keys, dtype=torch.int32, device=db.device)
    if mesh is not None:
        from repro_torch.core.query.executor_spmd import compile_query_spmd
        fn = compile_query_spmd(db.cfg, plan, caps, Q, mesh, backend=be,
                                xwin=index_window(db))
    else:
        fn = compile_query(db.cfg, plan, caps, Q, be, xwin=index_window(db))
    out = fn(db.store, keys, torch.ones((Q,), dtype=torch.bool,
                                        device=db.device), int(read_ts))
    return _to_result(plan, out)
