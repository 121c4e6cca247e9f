"""Query execution, single-address-space mode (§3.4).

Port of ``repro/core/query/executor.py``: the per-plan executor that runs a
uniform batch (one plan shape, one snapshot) with a §3.4 working-set budget
shared by the batch.  Execution mirrors the paper's operator set: index scan
-> [edge enumeration -> predicate evaluation -> dedup]* -> aggregate, at one
snapshot, with fixed capacities and a fast-fail flag instead of spill.
PyTorch runs eagerly, so :func:`compile_query` returns a plain function; its
cache is keyed like the JAX program cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import edges as edges_mod
from repro_torch.core import index as index_mod
from repro_torch.core.addressing import NULL, StoreConfig
from repro_torch.core.query.a1ql import Plan, Pred
from repro_torch.core.store import GraphStore, visible

I32MAX = 2**31 - 1
_NULL = int(NULL)


@dataclasses.dataclass(frozen=True)
class QueryCaps:
    """Static working-set capacities (the paper's §3.4 memory budget; the
    optional A1QL hints map to these)."""
    frontier: int = 1024       # live (qid, gid) pairs between hops
    expand: int = 4096         # CSR expansion slots per hop
    results: int = 64          # rows returned per query
    bucket: int = 256          # SPMD routing bucket (an A1QL hint; the
                               # SPMD executors are a later slice)


@dataclasses.dataclass
class QueryResult:
    counts: Optional[np.ndarray] = None      # (Q,) for terminal 'count'
    rows_gid: Optional[np.ndarray] = None    # (Q, K) for terminal 'select'
    rows: Optional[dict] = None              # (kind, col) -> (Q, K)
    truncated: Optional[np.ndarray] = None   # (Q,) rows overflowed K
    failed: bool = False                     # fast-fail (capacity overflow)
    failed_q: Optional[np.ndarray] = None    # (Q,) per-query fast-fail flags
                                             # (fused planner only)
    deadline_q: Optional[np.ndarray] = None  # (Q,) skipped by the deadline


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------

def eval_pred(pred: Pred, f_data, i_data, keys):
    """Vertex predicate evaluation; ``f_data``/``i_data`` may carry any
    leading batch shape."""
    if pred.kind == "f32":
        x, v = f_data[..., pred.col], float(np.float32(pred.val))
    elif pred.kind == "i32":
        x, v = i_data[..., pred.col], int(pred.val)
    else:
        x, v = keys, int(pred.val)
    if pred.op == "==":
        return x == v
    if pred.op == "!=":
        return x != v
    if pred.op == "<":
        return x < v
    if pred.op == "<=":
        return x <= v
    if pred.op == ">":
        return x > v
    return x >= v


def sort_pairs(qids, gids, valid):
    """Sort (qid, gid) pairs; invalid entries to the end.  Returns sorted
    (qids, gids, valid, first_of_run mask).  The two int32 keys are packed
    into one int64 (qid high, gid biased into the low word), so one sort
    gives the lexicographic order."""
    k1 = torch.where(valid, qids, I32MAX).long()
    k2 = torch.where(valid, gids, I32MAX).long()
    packed = torch.sort((k1 << 32) + (k2 + 2**31)).values
    k1 = (packed >> 32).to(torch.int32)
    k2 = ((packed & 0xFFFFFFFF) - 2**31).to(torch.int32)
    valid_s = k1 != I32MAX
    neg = torch.full((1,), -1, dtype=torch.int32, device=k1.device)
    prev1 = torch.cat([neg, k1[:-1]])
    prev2 = torch.cat([neg, k2[:-1]])
    first = valid_s & ((k1 != prev1) | (k2 != prev2))
    return (torch.where(valid_s, k1, _NULL), torch.where(valid_s, k2, _NULL),
            valid_s, first)


def _scatter_drop(n: int, pos, vals, fill):
    """``full(n, fill).at[pos].set(vals, mode='drop')`` for pos >= 0: a
    buffer one slot longer takes the dropped writes and is then cut."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    out[torch.where(pos < n, pos, n)] = vals
    return out[:n]


def dedup_compact(qids, gids, valid, cap: int):
    """Dedup (qid, gid) pairs and compact to ``cap`` slots (the
    coordinator's "aggregated, duplicates removed" step).  Returns (qids',
    gids', valid', overflow)."""
    q_s, g_s, v_s, first = sort_pairs(qids, gids, valid)
    fi = first.to(torch.int32)
    n_unique = fi.sum(dtype=torch.int32)
    pos = torch.where(first, torch.cumsum(fi, 0, dtype=torch.int32) - 1,
                      I32MAX)
    out_q = _scatter_drop(cap, pos, q_s, _NULL)
    out_g = _scatter_drop(cap, pos, g_s, _NULL)
    return out_q, out_g, out_q >= 0, n_unique > cap


def check_vertices(store: GraphStore, cfg: StoreConfig, qids, gids, valid,
                   read_ts, target_vtype: int, pred: Optional[Pred]):
    """Liveness + type + predicate check of arrived vertices."""
    ok = valid & (gids >= 0)
    rows = cfg.row_of_gid(torch.where(ok, gids, 0))
    alive = ok & visible(store.v_create[rows], store.v_delete[rows], read_ts)
    if target_vtype >= 0:
        alive = alive & (store.vtype[rows] == int(target_vtype))
    if pred is not None:
        use_cur = (store.vdata_ts[rows] <= read_ts)[:, None]
        f = torch.where(use_cur, store.vdata_f[rows], store.vprev_f[rows])
        i = torch.where(use_cur, store.vdata_i[rows], store.vprev_i[rows])
        alive = alive & eval_pred(pred, f, i, store.vkey[rows])
    return alive


def select_attrs(store: GraphStore, cfg: StoreConfig, rows_gid, read_ts,
                 select):
    """Gather the selected attribute columns of (Q, K) result rows (NULL
    keys and zero attributes in empty cells)."""
    present = rows_gid >= 0
    r = cfg.row_of_gid(torch.where(present, rows_gid, 0))
    use_cur = store.vdata_ts[r] <= read_ts
    out = {}
    for kind, colid in select:
        if kind == "key":
            vals = torch.where(present, store.vkey[r], _NULL)
        elif kind == "f32":
            vals = torch.where(use_cur, store.vdata_f[r, colid],
                               store.vprev_f[r, colid]) * present
        else:
            vals = torch.where(use_cur, store.vdata_i[r, colid],
                               store.vprev_i[r, colid]) * present
        out[(kind, colid)] = vals
    return out


def build_select(store: GraphStore, cfg: StoreConfig, plan: Plan,
                 qids, gids, valid, read_ts, n_queries: int, k: int):
    """Scatter final (qid, gid) pairs into per-query rows + gather attrs."""
    q_s, g_s, v_s, first = sort_pairs(qids, gids, valid)
    # position within each query's run (dedup'd), searched over an
    # I32MAX-padded view (q_s pads invalid with NULL, breaking sortedness)
    q_srch = torch.where(v_s, q_s, I32MAX)
    fi = first.to(torch.int32)
    c = torch.cumsum(fi, 0, dtype=torch.int32)
    run_start = torch.searchsorted(q_srch, q_srch, out_int32=True)
    excl = c - fi
    pos_in_q = excl - excl[run_start]
    row = torch.where(first & (q_s >= 0), q_s, I32MAX)
    over = first & (pos_in_q >= k)
    col = torch.where(first & ~over, pos_in_q, I32MAX)

    ok = (row < n_queries) & (col < k)
    flat = torch.where(ok, row.long() * k + col, n_queries * k)
    rows_gid = _scatter_drop(n_queries * k, flat, g_s, _NULL).reshape(
        n_queries, k)
    truncated = _scatter_drop(
        n_queries, torch.where(over, q_s, I32MAX),
        torch.ones_like(over), False)
    attrs = select_attrs(store, cfg, rows_gid, read_ts,
                         tuple(zip(plan.select_kind, plan.select_cols)))
    return rows_gid, attrs, truncated


def _segment_count(mask, seg, n: int):
    """``segment_sum(mask, seg, n)`` for int32 counts; seg in [0, n]."""
    out = torch.zeros((n + 1,), dtype=torch.int32, device=mask.device)
    return out.index_add_(0, seg, mask.to(torch.int32))[:n]


# ---------------------------------------------------------------------------
# chain execution (lookup -> hops -> terminal)
# ---------------------------------------------------------------------------

def _chain_frontier(store, cfg: StoreConfig, plan: Plan, caps: QueryCaps,
                    keys, valid, read_ts,
                    backend: backend_mod.Backend = backend_mod.REF,
                    xwin: Optional[int] = None):
    """Run index lookup + all hops; returns final (qids, gids, valid,
    failed)."""
    Q = keys.shape[0]
    F = caps.frontier
    dev = keys.device
    vt = torch.full((Q,), plan.start_vtype, dtype=torch.int32, device=dev)
    gids, found = index_mod.lookup(store, cfg, vt, keys, valid, read_ts,
                                   backend=backend, xd_win=xwin)
    pad = F - Q
    if pad < 0:
        raise ValueError("frontier capacity below query batch size")
    ok = valid & found
    fill = torch.full((pad,), _NULL, dtype=torch.int32, device=dev)
    qids = torch.cat([torch.where(
        ok, torch.arange(Q, dtype=torch.int32, device=dev), _NULL), fill])
    gids = torch.cat([torch.where(ok, gids, _NULL), fill])
    vmask = gids >= 0
    failed = torch.zeros((), dtype=torch.bool, device=dev)

    for hop in plan.hops:
        oq, on, ov, ovf = edges_mod.expand(
            store, cfg, qids, gids, vmask, etype=int(hop.etype),
            direction=hop.direction, read_ts=read_ts, cap_out=caps.expand,
            backend=backend)
        failed = failed | ovf
        qids, gids, vmask, ovf2 = dedup_compact(oq, on, ov, F)
        failed = failed | ovf2
        vmask = vmask & check_vertices(store, cfg, qids, gids, vmask, read_ts,
                                       hop.target_vtype, hop.pred)
        gids = torch.where(vmask, gids, _NULL)
        qids = torch.where(vmask, qids, _NULL)
    return qids, gids, vmask, failed


def _terminal(store, cfg, plan, caps, qids, gids, vmask, read_ts, Q: int):
    if plan.final_pred is not None:
        vmask = vmask & check_vertices(store, cfg, qids, gids, vmask, read_ts,
                                       -1, plan.final_pred)
        gids = torch.where(vmask, gids, _NULL)
        qids = torch.where(vmask, qids, _NULL)
    if plan.terminal == "count":
        q_s, g_s, v_s, first = sort_pairs(qids, gids, vmask)
        return {"counts": _segment_count(first, torch.where(first, q_s, Q),
                                         Q)}
    rows_gid, attrs, trunc = build_select(store, cfg, plan, qids, gids, vmask,
                                          read_ts, Q, caps.results)
    return {"rows_gid": rows_gid, "attrs": attrs, "truncated": trunc}


def _run_intersect(store, cfg, plan: Plan, caps: QueryCaps, keys_b, valid,
                   read_ts, Q: int,
                   backend: backend_mod.Backend = backend_mod.REF,
                   xwin: Optional[int] = None):
    """Star-pattern intersection (Q3): keep vertices reached by all
    branches."""
    B = len(plan.branches)
    parts = []
    failed = torch.zeros((), dtype=torch.bool, device=keys_b.device)
    for bi, branch in enumerate(plan.branches):
        q, g, v, f = _chain_frontier(store, cfg, branch, caps, keys_b[bi],
                                     valid, read_ts, backend, xwin)
        failed = failed | f
        parts.append((q, g, v))
    qids, gids, vmask = (torch.cat(x) for x in zip(*parts))
    q_s, g_s, v_s, first = sort_pairs(qids, gids, vmask)
    n = q_s.shape[0]
    run_id = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    run_id = torch.where(v_s, run_id, n - 1)
    run_len = _segment_count(v_s, run_id, n)
    keep = first & (run_len[run_id] == B)
    kq = torch.where(keep, q_s, _NULL)
    kg = torch.where(keep, g_s, _NULL)
    return _terminal(store, cfg, plan, caps, kq, kg, keep, read_ts, Q), failed


# per-plan-shape cache, keyed like the JAX program cache
_CACHE: dict = {}


def compile_query(cfg: StoreConfig, plan: Plan, caps: QueryCaps,
                  n_queries: int,
                  backend: backend_mod.Backend = backend_mod.REF,
                  xwin: Optional[int] = None):
    """The executor for one plan shape: ``run(store, keys, valid, read_ts)``
    (``keys`` is (Q,) for a chain, (branches, Q) for a star)."""
    key = (cfg, plan, caps, n_queries, backend, xwin, "local")
    if key in _CACHE:
        return _CACHE[key]

    if plan.is_intersect:
        def run(store, keys_b, valid, read_ts):
            out, failed = _run_intersect(store, cfg, plan, caps, keys_b,
                                         valid, read_ts, n_queries, backend,
                                         xwin)
            out["failed"] = failed
            return out
    else:
        def run(store, keys, valid, read_ts):
            q, g, v, failed = _chain_frontier(store, cfg, plan, caps, keys,
                                              valid, read_ts, backend, xwin)
            out = _terminal(store, cfg, plan, caps, q, g, v, read_ts,
                            n_queries)
            out["failed"] = failed
            return out

    _CACHE[key] = run
    return run


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _to_result(plan: Plan, out: dict) -> QueryResult:
    res = QueryResult(failed=bool(out["failed"]))
    if plan.terminal == "count":
        res.counts = _np(out["counts"])
    else:
        res.rows_gid = _np(out["rows_gid"])
        res.truncated = _np(out["truncated"])
        res.rows = {k: _np(v) for k, v in out["attrs"].items()}
    return res
