"""Distributed query execution: query shipping over a shard mesh (§3.4).

Port of ``repro/core/query/executor_spmd.py``: the paper's coordinator /
worker protocol as one lockstep program over the shards of a
:class:`repro_torch.dist.mesh.ShardMesh`.  Per hop:

  1. *map pointers -> hosts*: each shard buckets its live frontier pairs by
     ``owner = gid % S``, local arithmetic like A1's CM metadata;
  2. *batched RPCs*: one ``all_to_all`` ships every bucket to its owner
     (operators move, not data);
  3. *worker step*: the owner checks the arrived vertices (liveness, type,
     predicate), enumerates edges from its own CSR block and delta log, and
     emits (qid, dst) pairs;
  4. *repartition*: emitted pairs stay put; the next hop's routing step is
     the paper's "repartitioned by pointer address".

Dedup is shard-local after routing (each gid has one owner), counts
aggregate with one ``psum``, and capacity overflow anywhere raises the
fast-fail flag.  Every per-shard step below runs once per shard on that
shard's block of the store (``shard_store``); the collectives take and
return the list of per-shard tensors.  The local executor (``executor.py``)
defines the semantics, and the results equal the JAX package's
``GraphDB.query(mesh=...)`` bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import index as index_mod
from repro_torch.core.addressing import NULL, StoreConfig
from repro_torch.core.edges import (_csr_arrays, _delta_arrays,
                                    _tiled_csr_expand)
from repro_torch.core.query.a1ql import Plan, Pred
from repro_torch.core.query.executor import (I32MAX, QueryCaps, _scatter_drop,
                                             _segment_count, dedup_compact,
                                             eval_pred, sort_pairs)
from repro_torch.core.store import GraphStore, visible
from repro_torch.dist import mesh as mesh_mod

_NULL = int(NULL)
MULTI_Q = 8     # frontier matches a delta entry may emit (§3.4 capacity)


def stable_sort_by(key, *vals, dim: int = -1):
    """``jax.lax.sort((key, *vals), num_keys=1)``: ``vals`` reordered by a
    stable ascending sort of ``key`` (ties keep their input order, as the
    stable XLA sort keeps them)."""
    order = torch.sort(key, dim=dim, stable=True)
    return (order.values, *(v.gather(dim, order.indices) for v in vals))


def _i32(n: int, fill: int, dev):
    return torch.full((n,), fill, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# local-block primitives (the "worker" operators, one shard's block)
# ---------------------------------------------------------------------------

def _lookup_local(st: GraphStore, cfg: StoreConfig, me: int, vtypes, keys,
                  valid, read_ts,
                  backend: backend_mod.Backend = backend_mod.REF,
                  xd_win: Optional[int] = None):
    """Primary-index probe against *my* index block.  Only queries whose key
    routes to me produce a gid; every other shard emits NULL for them.  The
    block is one sorted array, so the kernel backend probes the whole batch
    with one ``searchsorted_left`` launch.  ``read_ts`` is a scalar or a
    ``(Q,)`` tensor; ``xd_win`` windows the index-delta scan to the host
    fill counts (``planner.index_window``)."""
    S, cap_x, cap_xd = cfg.n_shards, cfg.cap_idx, cfg.cap_idx_delta
    dev = keys.device
    Q = keys.shape[0]
    mine = valid & (index_mod.route(vtypes, keys, S) == me)
    h = index_mod.mix32(vtypes, keys)
    ix_h = torch.where(st.ix_gid >= 0, index_mod.mix32(st.ix_vtype,
                                                        st.ix_key), I32MAX)
    pos0 = backend_mod.searchsorted(ix_h, h, backend=backend)
    best_g, best_ts = _i32(Q, _NULL, dev), _i32(Q, -1, dev)
    for w in range(16):
        p = torch.clamp(pos0 + w, max=cap_x - 1)
        g_r, c_r = st.ix_gid[p], st.ix_create[p]
        hit = ((g_r >= 0) & (st.ix_vtype[p] == vtypes)
               & (st.ix_key[p] == keys)
               & visible(c_r, st.ix_delete[p], read_ts))
        newer = hit & (c_r > best_ts)
        best_g = torch.where(newer, g_r, best_g)
        best_ts = torch.where(newer, c_r, best_ts)
    g_main = torch.where(mine, best_g, _NULL)
    # delta scan: my block is one shard, so the window is [:W]
    W = cap_xd if xd_win is None else min(int(xd_win), cap_xd)
    xd_vt, xd_k, xd_g, xd_c, xd_d = (
        a[:W] for a in (st.xd_vtype, st.xd_key, st.xd_gid, st.xd_create,
                        st.xd_delete))
    rts = read_ts
    if isinstance(rts, torch.Tensor) and rts.dim() == 1:
        rts = rts[:, None]
    m = (mine[:, None]
         & (xd_vt[None, :] == vtypes[:, None])
         & (xd_k[None, :] == keys[:, None])
         & (xd_g >= 0)[None, :]
         & visible(xd_c[None, :], xd_d[None, :], rts))
    ts_d = torch.where(m, xd_c[None, :], -1)
    best_d = torch.argmax(ts_d, dim=1)        # first maximum, as jnp.argmax
    ts_delta = ts_d.amax(dim=1)
    g_delta = torch.where(ts_delta >= 0, xd_g[best_d], _NULL)
    return torch.where(ts_delta > best_ts, g_delta, g_main)


def _expand_local(st: GraphStore, cfg: StoreConfig, qids, gids, valid, *,
                  etype: int, direction: str, read_ts, cap_out: int,
                  backend: backend_mod.Backend = backend_mod.REF):
    """Edge enumeration from my CSR block + delta log (gids owned by me).

    Returns (qids, nbrs, overflow) of shape (cap_out + cap_delta*MULTI_Q,).
    The delta merge sorts the frontier by slot once and binary-searches each
    delta entry into it, emitting at most MULTI_Q frontier matches an entry;
    more queries parked on one vertex fast-fail (the §3.4 contract)."""
    S = cfg.n_shards
    dev = gids.device
    indptr, nbr, typ, ecre, edel = _csr_arrays(st, direction)
    dslot, dnbr, dtyp, dcre, ddel = _delta_arrays(st, direction)
    slot = torch.where(valid, gids // S, 0)
    start = indptr[slot]
    deg = (indptr[slot + 1] - indptr[slot]) * valid
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    total = cum[-1]
    overflow = total > cap_out
    if backend.is_kernel:
        out_q, out_n = _tiled_csr_expand(qids, deg, start,
                                         (nbr, typ, ecre, edel), etype,
                                         read_ts, cap_out)
    else:
        k = torch.arange(cap_out, dtype=torch.int32, device=dev)
        item = torch.searchsorted(cum, k, right=True, out_int32=True)
        item_c = torch.clamp(item, max=deg.shape[0] - 1)
        base = cum[item_c] - deg[item_c]
        epos = torch.where(k < total, start[item_c] + (k - base), 0)
        e_ok = ((k < total)
                & visible(ecre[epos], edel[epos], read_ts)
                & ((etype < 0) | (typ[epos] == etype))
                & (nbr[epos] >= 0))
        out_q = torch.where(e_ok, qids[item_c], _NULL)
        out_n = torch.where(e_ok, nbr[epos], _NULL)

    # ---- delta merge (tier 2) ---------------------------------------------
    slot_s, qid_s = stable_sort_by(torch.where(valid, slot, I32MAX), qids)
    d_ok = ((dnbr >= 0) & visible(dcre, ddel, read_ts)
            & ((etype < 0) | (dtyp == etype)))
    d_slot_q = torch.where(d_ok, dslot, I32MAX)
    lo = torch.searchsorted(slot_s, d_slot_q, out_int32=True)
    hi = torch.searchsorted(slot_s, d_slot_q, right=True, out_int32=True)
    overflow = overflow | (d_ok & (hi - lo > MULTI_Q)).any()
    w = torch.arange(MULTI_Q, dtype=torch.int32, device=dev)
    pos = torch.clamp(lo[:, None] + w[None, :], max=slot_s.shape[0] - 1)
    hit = (lo[:, None] + w[None, :] < hi[:, None]) & d_ok[:, None]
    dq = torch.where(hit, qid_s[pos], _NULL).reshape(-1)
    dn = torch.where(hit, dnbr[:, None], _NULL).reshape(-1)
    return torch.cat([out_q, dq]), torch.cat([out_n, dn]), overflow


def _check_local(st: GraphStore, cfg: StoreConfig, gids, valid, read_ts,
                 target_vtype: int, pred: Optional[Pred]):
    """Liveness/type/predicate of vertices I own (arrived via routing)."""
    S = cfg.n_shards
    rows = torch.where(valid, gids // S, 0)
    alive = valid & visible(st.v_create[rows], st.v_delete[rows], read_ts)
    if target_vtype >= 0:
        alive = alive & (st.vtype[rows] == int(target_vtype))
    if pred is not None:
        use_cur = (st.vdata_ts[rows] <= read_ts)[:, None]
        f = torch.where(use_cur, st.vdata_f[rows], st.vprev_f[rows])
        i = torch.where(use_cur, st.vdata_i[rows], st.vprev_i[rows])
        alive = alive & eval_pred(pred, f, i, st.vkey[rows])
    return alive


def _bucket(qids, gids, valid, S: int, B: int):
    """One shard's RPC buckets: pairs sorted (stably) by owner into (S, B)
    slots; returns (bq, bg, overflow)."""
    N = qids.shape[0]
    dev = qids.device
    owner = torch.where(valid, gids % S, S)
    o_s, q_s, g_s = stable_sort_by(owner, qids, gids)
    starts = torch.searchsorted(
        o_s, torch.arange(S, dtype=o_s.dtype, device=dev), out_int32=True)
    col = torch.arange(N, dtype=torch.int32, device=dev) - starts[
        torch.clamp(o_s, max=S - 1)]
    ok = o_s < S
    overflow = (ok & (col >= B)).any()
    keep = ok & (col < B)
    flat = torch.where(keep, o_s * B + col, S * B)
    return (_scatter_drop(S * B, flat, q_s, _NULL),
            _scatter_drop(S * B, flat, g_s, _NULL), overflow)


def _route(qids, gids, valid, S: int, B: int):
    """Bucket by owner + one all_to_all (the batched per-machine RPCs), on
    per-shard lists; returns per-shard (qids, gids, overflow)."""
    bq, bg, ovf = zip(*(_bucket(q, g, v, S, B)
                        for q, g, v in zip(qids, gids, valid)))
    return mesh_mod.all_to_all(list(bq)), mesh_mod.all_to_all(list(bg)), \
        list(ovf)


# ---------------------------------------------------------------------------
# the lockstep program
# ---------------------------------------------------------------------------

def _spmd_chain(sts, cfg: StoreConfig, plan: Plan, caps: QueryCaps, keys,
                valid, read_ts,
                backend: backend_mod.Backend = backend_mod.REF,
                xwin: Optional[int] = None):
    """Index scan + hops on every shard.  Returns per-shard lists (qids,
    gids, valid), the (vtype, pred) check owed to the *next* routing step
    (vertex predicates run at the vertex's owner) and per-shard failed
    flags."""
    S, F, B = cfg.n_shards, caps.frontier, caps.bucket
    Q = keys[0].shape[0]
    if F < Q:
        raise ValueError("frontier capacity below query batch")
    qids, gids, vmask, failed = [], [], [], []
    for me, (st, k, v) in enumerate(zip(sts, keys, valid)):
        dev = k.device
        vt = _i32(Q, plan.start_vtype, dev)
        g0 = _lookup_local(st, cfg, me, vt, k, v, read_ts, backend,
                           xd_win=xwin)
        fill = _i32(F - Q, _NULL, dev)
        qids.append(torch.cat([torch.where(
            g0 >= 0, torch.arange(Q, dtype=torch.int32, device=dev),
            _NULL), fill]))
        gids.append(torch.cat([torch.where(g0 >= 0, g0, _NULL), fill]))
        vmask.append(gids[-1] >= 0)
        failed.append(torch.zeros((), dtype=torch.bool, device=dev))
    pending = (plan.start_vtype, None)

    for hop in plan.hops:
        rq, rg, ovf = _route(qids, gids, vmask, S, B)
        qids, gids, vmask = [], [], []
        for s, st in enumerate(sts):
            q, g, v, ovf2 = dedup_compact(rq[s], rg[s], rg[s] >= 0, F)
            alive = _check_local(st, cfg, g, v, read_ts, *pending)
            oq, on, ovf3 = _expand_local(
                st, cfg, q, g, v & alive, etype=int(hop.etype),
                direction=hop.direction, read_ts=read_ts,
                cap_out=caps.expand, backend=backend)
            q, g, v, ovf4 = dedup_compact(oq, on, on >= 0, F)
            failed[s] = failed[s] | ovf[s] | ovf2 | ovf3 | ovf4
            qids.append(q)
            gids.append(g)
            vmask.append(v)
        pending = (hop.target_vtype, hop.pred)
    return qids, gids, vmask, pending, failed


def _finalize(sts, cfg: StoreConfig, plan: Plan, caps: QueryCaps, qids, gids,
              vmask, pending, read_ts, Q: int, failed):
    """Final route -> owner-side checks -> dedup -> aggregate."""
    S, F, B, K = cfg.n_shards, caps.frontier, caps.bucket, caps.results
    rq, rg, ovf = _route(qids, gids, vmask, S, B)
    fin = []
    for s, st in enumerate(sts):
        q, g, v, ovf2 = dedup_compact(rq[s], rg[s], rg[s] >= 0, F)
        failed[s] = failed[s] | ovf[s] | ovf2
        alive = _check_local(st, cfg, g, v, read_ts, *pending)
        if plan.final_pred is not None:
            alive = alive & _check_local(st, cfg, g, v, read_ts, -1,
                                         plan.final_pred)
        v = v & alive
        fin.append((torch.where(v, q, _NULL), torch.where(v, g, _NULL), v))
    failed_global = mesh_mod.psum([f.to(torch.int32) for f in failed])[0] > 0

    if plan.terminal == "count":
        counts = mesh_mod.psum([
            _segment_count(v, torch.where(v, q, Q), Q) for q, _, v in fin])
        return {"counts": counts[0], "failed": failed_global}

    out = select_shard_major(sts, cfg, fin, [read_ts] * S, Q, K, tuple(
        zip(plan.select_kind, plan.select_cols)))
    out["failed"] = failed_global
    return out


def select_shard_major(sts, cfg: StoreConfig, pairs, ts, Q: int, K: int,
                       select):
    """The select terminal on a mesh: globally consistent row positions.

    ``pairs`` holds each shard's final (qids, gids, valid), owner-resident
    and unique; ``ts`` each shard's snapshot, a scalar or a (Q,) tensor.
    Each shard places its rows of query q after the rows of the shards
    before it (an ``all_gather`` of the per-shard counts), so rows come out
    shard-major; the (Q, K) cells aggregate with ``psum``, gids as
    ``gid + 1`` so that empty cells come back NULL.  Returns rows_gid,
    attrs and truncated."""
    S = cfg.n_shards
    local = []
    for q, g, v in pairs:
        q_s, g_s, v_s, _ = sort_pairs(q, g, v)
        local.append((q_s, g_s, v_s,
                      _segment_count(v_s, torch.where(v_s, q_s, Q), Q)))
    all_counts = mesh_mod.all_gather([x[3] for x in local])   # (S, Q)
    acc_gid, acc_trunc, acc_attr = [], [], []
    for me, (st, (q_s, g_s, v_s, _)) in enumerate(zip(sts, local)):
        before = (torch.arange(S, device=v_s.device) < me)[:, None]
        base = (all_counts[me] * before).sum(0, dtype=torch.int32)   # (Q,)
        q_srch = torch.where(v_s, q_s, I32MAX)
        run_start = torch.searchsorted(q_srch, q_srch, out_int32=True)
        vi = v_s.to(torch.int32)
        excl = torch.cumsum(vi, 0, dtype=torch.int32) - vi
        qsafe = torch.where(v_s, q_s, 0)
        pos = base[qsafe] + (excl - excl[run_start])
        over = v_s & (pos >= K)
        flat = torch.where(v_s & ~over, q_s.long() * K + pos, Q * K)
        acc_gid.append(_scatter_drop(Q * K, flat, g_s + 1, 0))
        acc_trunc.append(_scatter_drop(Q, torch.where(over, q_s, I32MAX),
                                       torch.ones_like(q_s), 0))
        rows_local = torch.where(v_s, g_s // S, 0)
        t = ts[me][qsafe] if isinstance(ts[me], torch.Tensor) else ts[me]
        use_cur = st.vdata_ts[rows_local] <= t
        cols = []
        for kind, colid in select:
            if kind == "key":
                vals = st.vkey[rows_local]
            elif kind == "f32":
                vals = torch.where(use_cur, st.vdata_f[rows_local, colid],
                                   st.vprev_f[rows_local, colid])
            else:
                vals = torch.where(use_cur, st.vdata_i[rows_local, colid],
                                   st.vprev_i[rows_local, colid])
            cols.append(_scatter_drop(Q * K, flat, vals, 0))
        acc_attr.append(cols)
    rows_gid = (mesh_mod.psum(acc_gid)[0] - 1).reshape(Q, K)   # 0 -> NULL
    attrs = {}
    for j, (kind, colid) in enumerate(select):
        summed = mesh_mod.psum([a[j] for a in acc_attr])[0].reshape(Q, K)
        if kind == "key":     # empty cells read NULL like the local path
            summed = torch.where(rows_gid >= 0, summed, _NULL)
        attrs[(kind, colid)] = summed
    return {"rows_gid": rows_gid, "attrs": attrs,
            "truncated": mesh_mod.psum(acc_trunc)[0] > 0}


def _intersect(sts, cfg: StoreConfig, plan: Plan, caps: QueryCaps, keys_b,
               valid, read_ts, backend, xwin):
    """Star pattern: every branch resolved fully (route + check), then a
    shard-local intersection: every branch's copy of a gid lives on the
    gid's owner (ownership routing = equi-join locality)."""
    S, F, Bk = cfg.n_shards, caps.frontier, caps.bucket
    n_br = len(plan.branches)
    parts = [[] for _ in sts]
    failed = None
    for bi, br in enumerate(plan.branches):
        q, g, v, pend, f = _spmd_chain(sts, cfg, br, caps,
                                       [k[bi] for k in keys_b], valid,
                                       read_ts, backend, xwin)
        rq, rg, ovf = _route(q, g, v, S, Bk)
        for s, st in enumerate(sts):
            q2, g2, v2, ovf2 = dedup_compact(rq[s], rg[s], rg[s] >= 0, F)
            v2 = v2 & _check_local(st, cfg, g2, v2, read_ts, *pend)
            f[s] = f[s] | ovf[s] | ovf2
            parts[s].append((torch.where(v2, q2, _NULL),
                             torch.where(v2, g2, _NULL), v2))
        failed = f if failed is None else [a | b for a, b in zip(failed, f)]
    kq, kg, keep = [], [], []
    for p in parts:
        q_s, g_s, v_s, first = sort_pairs(*(torch.cat(x) for x in zip(*p)))
        n = q_s.shape[0]
        run_id = torch.where(v_s, torch.cumsum(first.to(torch.int32), 0,
                                               dtype=torch.int32) - 1, n - 1)
        run_len = _segment_count(v_s, run_id, n)
        k = first & (run_len[run_id] == n_br)
        kq.append(torch.where(k, q_s, _NULL))
        kg.append(torch.where(k, g_s, _NULL))
        keep.append(k)
    return kq, kg, keep, failed


# per-plan-shape cache, keyed like the JAX program cache
_CACHE: dict = {}


def compile_query_spmd(cfg: StoreConfig, plan: Plan, caps: QueryCaps,
                       n_queries: int, mesh: mesh_mod.ShardMesh,
                       backend: backend_mod.Backend = backend_mod.REF,
                       xwin: Optional[int] = None):
    """The SPMD executor for one plan shape: ``run(store, keys, valid,
    read_ts)`` over the whole store (split by ``shard_store``); ``keys`` is
    (Q,) for a chain, (branches, Q) for a star.  ``xwin`` is the
    primary-index delta window (``planner.index_window``)."""
    key = (cfg, plan, caps, n_queries, mesh, backend, xwin)
    if key in _CACHE:
        return _CACHE[key]

    def run(store, keys, valid, read_ts):
        sts = mesh_mod.shard_store(store, cfg, mesh)
        keys_l, valid_l = mesh.replicate(keys), mesh.replicate(valid)
        if plan.is_intersect:
            q, g, v, failed = _intersect(sts, cfg, plan, caps, keys_l,
                                         valid_l, read_ts, backend, xwin)
            pending = (-1, None)
        else:
            q, g, v, pending, failed = _spmd_chain(
                sts, cfg, plan, caps, keys_l, valid_l, read_ts, backend,
                xwin)
        return _finalize(sts, cfg, plan, caps, q, g, v, pending, read_ts,
                         n_queries, failed)

    _CACHE[key] = run
    return run
