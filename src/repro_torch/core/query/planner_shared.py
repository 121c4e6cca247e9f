"""Shared-frontier fused execution (§3.4 at serving scale).

Port of the local path of ``repro/core/query/planner_shared.py``.  The
per-query-budget waves (``planner.py``) give every chain unit a private
``(frontier,)`` region: an ``(R, F)`` matrix whose footprint grows linearly
with the number of concurrent units.  Here every live query shares **one**
flat pool of ``(seg, gid)`` pairs, compacted once per hop:

  * the frontier is two flat ``(FS,)`` arrays, ``seg`` (the chain unit that
    owns the pair; R = empty) and ``gid`` (PAD = empty), kept sorted by
    (seg, gid), so each segment's run stays ascending and binary search works
    where the per-query mode searched rows;
  * ``FS = planner.shared_budget(R, caps.frontier)`` is O(F*sqrt(R)) instead
    of O(F*R); the expansion pool ``ES`` scales the same way;
  * every capacity keeps its per-unit meaning too: a segment holds at most
    ``caps.frontier`` uniques and enumerates at most ``caps.expand`` raw
    edges, flagged as per-query mode flags them; on top, when a shared pool
    overflows, every owner whose pair was dropped gets its ``failed_q`` flag
    (and ``shared_ovf_q``): a hot query can evict its batch mates' slots only
    by flagging them;
  * so whenever a query's flag is clear, its results equal per-query mode's
    bit for bit.

Entry point: ``GraphDB.query(..., budget="shared")`` -> ``engine.execute``
-> ``planner.execute_fused(budget="shared")`` -> :func:`compile_batch_shared`.
The hop compaction is one ``backend.sort_pairs`` a hop (the ``sort_pairs``
kernel), the expansion runs the ``edge_expand`` kernel and the delta probe
the ``sorted_lookup`` kernel.  Under ``mesh=``,
:func:`compile_batch_shared_spmd` runs the same pool on every shard of a
``ShardMesh``, with routing buckets shared by every unit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import edges as edges_mod
from repro_torch.core import index as index_mod
from repro_torch.core.addressing import NULL, StoreConfig
from repro_torch.core.edges import TILE
from repro_torch.core.query.executor import (I32MAX, QueryCaps, _scatter_drop,
                                             _segment_count, build_select,
                                             eval_pred)
from repro_torch.core.query.planner import (PAD, _cache_get, _cache_put,
                                            _final_pred_groups, _knn_merge,
                                            _nearest_tables, _spmd_pending,
                                            _unit_tables, _wave_tables,
                                            shared_budget)
from repro_torch.core.store import visible, window_shard_major
from repro_torch.dist import mesh as mesh_mod

_NULL = int(NULL)


# ---------------------------------------------------------------------------
# flat wave primitives
# ---------------------------------------------------------------------------

def _flag_segs(failed_r, cond, segc, R: int):
    """OR per-segment flags: any True in ``cond`` flags its owner segment."""
    hit = torch.zeros((R + 1,), dtype=torch.bool, device=cond.device)
    hit[torch.where(cond, segc, R).long()] = True
    return failed_r | hit[:R]


def _prev(x):
    """``x`` shifted right by one, -1 first."""
    return torch.cat([torch.full((1,), -1, dtype=x.dtype, device=x.device),
                      x[:-1]])


def _dedup_pairs(seg, gid, valid, R: int, F: int, FS: int,
                 backend: backend_mod.Backend):
    """The shared compaction: flat (seg, gid) candidates -> the (FS,) pool.

    One lexicographic pair sort, then the first F uniques *per segment* (the
    per-unit §3.4 budget, flagged as per-query mode flags it), then the
    first FS survivors overall (the shared budget, flagging every owner
    whose pair is dropped).  Returns (seg', gid', failed_unit,
    failed_shared), sorted by (seg, gid) with ghosts (R, PAD) last."""
    s = torch.where(valid, seg, R).contiguous()
    g = torch.where(valid, gid, PAD).contiguous()
    s, g = backend_mod.sort_pairs(s, g, backend=backend)
    ok = s < R
    first = ok & ((s != _prev(s)) | (g != _prev(g)))
    fi = first.to(torch.int32)
    excl = torch.cumsum(fi, 0, dtype=torch.int32) - fi   # uniques before
    seg_start = torch.searchsorted(s, s, out_int32=True)
    rank_seg = excl - excl[seg_start.long()]         # unique rank in my seg
    over_seg = first & (rank_seg >= F)
    keep = first & (rank_seg < F)
    ki = keep.to(torch.int32)
    gcol = torch.cumsum(ki, 0, dtype=torch.int32) - ki
    over_shared = keep & (gcol >= FS)
    keep = keep & (gcol < FS)
    col = torch.where(keep, gcol, FS)
    out_s = _scatter_drop(FS, col, s, R)
    out_g = _scatter_drop(FS, col, g, PAD)
    zero = torch.zeros((R,), dtype=torch.bool, device=s.device)
    sc = torch.clamp(s, max=R)
    return (out_s, out_g, _flag_segs(zero, over_seg, sc, R),
            _flag_segs(zero, over_shared, sc, R))


def _expand_flat(start, deg, pools, et_s, ts_s, ES: int,
                 backend: backend_mod.Backend):
    """Flat CSR expansion: (FS,) spans -> (ES,) entries and their source
    slots.  Raw span entry j of slot i lands at ``excl_cumsum[i] + j``
    (entries at >= ES are cut; the caller flags their owners), masked by
    the slot's snapshot and edge type.  Both backends emit the same
    buffers."""
    nbr, typ, ecre, edel = pools
    FS = deg.shape[0]
    dev = deg.device
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    excl = cum - deg
    k = torch.arange(ES, dtype=torch.int32, device=dev)
    item_k = torch.searchsorted(cum, k, right=True, out_int32=True)
    item_kc = torch.clamp(item_k, max=FS - 1).long()
    if backend.is_kernel:
        deg_eff = torch.minimum(torch.clamp(ES - excl, min=0), deg)
        cap_tiles = FS + 1 + (ES + TILE - 1) // TILE
        (nbr_t, typ_t, cre_t, del_t), item, tw, _ = backend_mod.expand_tiles(
            start.contiguous(), deg_eff.contiguous(), pools, tile=TILE,
            cap_tiles=cap_tiles)
        item_c = torch.clamp(item, max=FS - 1).long()
        lane = torch.arange(TILE, dtype=torch.int32, device=dev)
        shape = (cap_tiles, TILE)
        nbr_t, typ_t = nbr_t.reshape(shape), typ_t.reshape(shape)
        cre_t, del_t = cre_t.reshape(shape), del_t.reshape(shape)
        et_t = et_s[item_c][:, None]
        # invalid lanes carry -1 in every pool: visible(-1,-1,ts) is False
        e_ok = (visible(cre_t, del_t, ts_s[item_c][:, None])
                & ((et_t < 0) | (typ_t == et_t)) & (nbr_t >= 0))
        posq = excl[item_c][:, None] + tw[:, None] * TILE + lane[None, :]
        pos = torch.where(e_ok, posq, ES)
        out_n = _scatter_drop(ES, pos.reshape(-1), nbr_t.reshape(-1), _NULL)
    else:
        in_range = k < cum[-1]
        epos = torch.where(in_range, start[item_kc] + (k - excl[item_kc]),
                           0).long()
        et_k = et_s[item_kc]
        e_ok = (in_range & visible(ecre[epos], edel[epos], ts_s[item_kc])
                & ((et_k < 0) | (typ[epos] == et_k)) & (nbr[epos] >= 0))
        out_n = torch.where(e_ok, nbr[epos], _NULL)
    return out_n, item_kc


def _delta_flat(gid_sorted, m, lo_r, hi_r, d_gid, dnbr, dtyp, dcre, ddel,
                et_r, ts_r, R: int, backend: backend_mod.Backend):
    """Delta-log matches: (R, D) membership probes into the flat pool.

    The pool is sorted by (seg, gid), so "(unit r, delta gid) is a live
    frontier pair" is one windowed binary search per (r, d) over unit r's
    run ``[lo_r, hi_r)``, through the ``searchsorted_ranged`` seam.  Returns
    flat (R*D,) candidate (seg, nbr) pairs."""
    D = d_gid.shape[0]
    q = d_gid[None, :].expand(R, D).reshape(-1).contiguous()
    lo = lo_r[:, None].expand(R, D).reshape(-1).contiguous()
    hi = hi_r[:, None].expand(R, D).reshape(-1).contiguous()
    pos = backend_mod.searchsorted_ranged(gid_sorted.contiguous(), q, lo, hi,
                                          backend=backend)
    at = torch.clamp(lo + pos, max=gid_sorted.shape[0] - 1).long()
    found = ((lo + pos < hi) & (gid_sorted[at] == q) & m[at]).reshape(R, D)
    hit = (found & (dnbr >= 0)[None, :]
           & visible(dcre[None, :], ddel[None, :], ts_r[:, None])
           & ((et_r[:, None] < 0) | (dtyp[None, :] == et_r[:, None])))
    dn = torch.where(hit, dnbr[None, :], _NULL)
    ds = torch.where(hit, torch.arange(R, dtype=torch.int32,
                                       device=hit.device)[:, None], R)
    return ds.reshape(-1), dn.reshape(-1)


def _check_flat(st, rows, valid, ts_s, tvt_s, preds, segc):
    """Per-slot liveness/type/predicate check (the flat ``_check_rows``);
    ``preds`` hold (Pred, (R+1,) mask) with the ghost segment last."""
    alive = valid & visible(st.v_create[rows], st.v_delete[rows], ts_s)
    alive = alive & ((tvt_s < 0) | (st.vtype[rows] == tvt_s))
    if preds:
        use_cur = (st.vdata_ts[rows] <= ts_s)[:, None]
        f = torch.where(use_cur, st.vdata_f[rows], st.vprev_f[rows])
        i = torch.where(use_cur, st.vdata_i[rows], st.vprev_i[rows])
        keys = st.vkey[rows]
        for pred, mask_x in preds:
            alive = alive & (~mask_x[segc] | eval_pred(pred, f, i, keys))
    return alive


def _seg_windows(seg, R: int):
    """[lo, hi) of every segment's run in the sorted pool."""
    r = torch.arange(R, dtype=seg.dtype, device=seg.device)
    return (torch.searchsorted(seg, r, out_int32=True),
            torch.searchsorted(seg, r, right=True, out_int32=True))


def _merge_flat(seg, gid, live, row2q_x, nbr_x, Q: int, FS: int,
                backend: backend_mod.Backend):
    """Intersect-merge on the flat pool: (seg, gid) -> (query, gid) pairs.

    Branch runs are sorted-unique, so after mapping segments to their query
    and one pair sort a gid's run length is its branch coverage; ``run ==
    n_branches`` keeps the star semantics (chains pass, run == 1).  The
    output is compacted and sorted by (query, gid) and cannot overflow."""
    segc = torch.clamp(seg, max=row2q_x.shape[0] - 1).long()
    qv = torch.where(live, row2q_x[segc], Q).contiguous()
    gv = torch.where(live, gid, PAD).contiguous()
    q_s, g_s = backend_mod.sort_pairs(qv, gv, backend=backend)
    ok = q_s < Q
    first = ok & ((q_s != _prev(q_s)) | (g_s != _prev(g_s)))
    run_id = torch.where(ok, torch.cumsum(first.to(torch.int32), 0,
                                          dtype=torch.int32) - 1, FS - 1)
    run_len = torch.zeros((FS,), dtype=torch.int32,
                          device=seg.device).index_add_(
        0, run_id.long(), ok.to(torch.int32))
    keep = first & (run_len[run_id.long()]
                    == nbr_x[torch.clamp(q_s, max=Q).long()])
    ki = keep.to(torch.int32)
    col = torch.where(keep, torch.cumsum(ki, 0, dtype=torch.int32) - ki, FS)
    qf = _scatter_drop(FS, col, q_s, Q)
    gf = _scatter_drop(FS, col, g_s, PAD)
    return qf, gf, qf < Q


def _ext(a, fill):
    """Append the ghost-segment entry to a per-unit table."""
    a = np.asarray(a)
    return np.concatenate([a, np.asarray([fill], a.dtype)])


# ---------------------------------------------------------------------------
# the local shared-frontier program
# ---------------------------------------------------------------------------

def compile_batch_shared(cfg: StoreConfig, plans: tuple, caps: QueryCaps,
                         backend: backend_mod.Backend = backend_mod.REF,
                         dwin: Optional[int] = None,
                         xwin: Optional[int] = None,
                         vwin: Optional[int] = None, device="cpu"):
    """The shared-frontier program for one batch shape:
    ``run(store, keys, vecs, valid_in, ts_q, cur_q)``, with the grouping,
    caching and ``vwin``/``vecs`` contract of ``planner.compile_batch``."""
    from repro_torch.core import vindex as vindex_mod

    dwin = cfg.cap_delta if dwin is None else min(dwin, cfg.cap_delta)
    device = torch.device(device)
    key = (cfg, plans, caps, len(plans), backend, dwin, xwin, vwin,
           str(device), "shared-local")
    fn = _cache_get(key)
    if fn is not None:
        return fn

    Q = len(plans)
    F, E, K = caps.frontier, caps.expand, caps.results
    S, cap_v, cap_e = cfg.n_shards, cfg.cap_v, cfg.cap_e
    chains, row2q_np, n_br_np, _ = _unit_tables(plans)
    R = len(chains)
    FS = shared_budget(R, F, caps.shared_frontier)
    ES = shared_budget(R, E, caps.shared_expand)
    if FS < R:
        raise ValueError(f"shared frontier budget {FS} below unit count {R}")
    has_star = any(p.is_intersect for p in plans)
    terminal = plans[0].terminal
    kvec_np, has_nearest, KMAX = _nearest_tables(chains, F)
    vw = (min(cfg.cap_vec if vwin is None else vwin, cfg.cap_vec)
          if has_nearest else 0)

    def dev_t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def dev_preds(groups):     # masks extended by the ghost segment / query
        return [(pred, dev_t(_ext(mask, False))) for pred, mask in groups]

    row2q = dev_t(row2q_np, torch.int64)
    row2q_x = dev_t(np.concatenate([row2q_np, [Q]]), torch.int32)
    nbr_x = dev_t(np.concatenate([n_br_np, [-1]]), torch.int32)
    start_vt = dev_t([c.start_vtype for c in chains], torch.int32)
    unit_ids = torch.arange(R, dtype=torch.int32, device=device)
    waves = [dict(act=dev_t(_ext(w.act, False)),
                  is_out=dev_t(_ext(w.is_out, False)),
                  etype=dev_t(w.etype, torch.int32),
                  etype_x=dev_t(_ext(w.etype, -1), torch.int32),
                  tvt_x=dev_t(_ext(w.tvt, -1), torch.int32),
                  preds=dev_preds(w.preds), any_out=w.any_out,
                  any_in=w.any_in)
             for w in _wave_tables(chains)]
    final_preds = dev_preds(_final_pred_groups(plans))
    d_shard = torch.arange(S * dwin, dtype=torch.int32, device=device) // dwin
    nmask = dev_t(kvec_np > 0)
    kvec = dev_t(kvec_np, torch.int32)
    colk = torch.arange(KMAX, dtype=torch.int32, device=device)[None, :]
    zero_r = torch.zeros((R,), dtype=torch.bool, device=device)

    def run(store, keys, vecs, valid_in, ts_q, cur_q):
        ts_r = ts_q[row2q]                                  # (R,) per unit
        ts_x = torch.cat([ts_r, ts_r.new_zeros((1,))])
        failed_r, shared_r = zero_r, zero_r   # shared_r: caused by the pools
        # ---- lookup wave ------------------------------------------------
        look_ok = valid_in & ~nmask if has_nearest else valid_in
        gids0, found = index_mod.lookup(store, cfg, start_vt, keys, look_ok,
                                        ts_r, backend=backend, xd_win=xwin)
        seg0 = torch.where(found & look_ok, unit_ids, R)
        gid0 = torch.where(found & look_ok, gids0, PAD)
        if has_nearest:
            # k-NN seeds enter the flat (seg, gid) pool beside the scan
            # probes; _dedup_pairs restores the sorted-run invariant
            vx = vindex_mod.window_arrays(store, cfg, vw)
            _, knn_g = backend_mod.knn_topk(vecs, vx[4], *vx[:4], start_vt,
                                            ts_r, KMAX, backend=backend)
            seeds_ok = (nmask[:, None] & (colk < kvec[:, None])
                        & (knn_g != I32MAX) & valid_in[:, None])
            seg_n = torch.where(seeds_ok, unit_ids[:, None], R)
            cand_s = torch.cat([seg0, seg_n.reshape(-1)])
            cand_g = torch.cat([gid0, torch.where(seeds_ok, knn_g,
                                                  PAD).reshape(-1)])
        else:
            cand_s, cand_g = seg0, gid0
        seg, gid, fu, fs = _dedup_pairs(cand_s, cand_g, cand_s < R, R, F, FS,
                                        backend)
        failed_r = failed_r | fu | fs
        shared_r = shared_r | fs
        live = seg < R

        for wave in waves:
            segc = torch.clamp(seg, max=R).long()
            act_s = wave["act"][segc]
            parked = live & ~act_s
            parts_s = [torch.where(parked, seg, R)]
            parts_g = [torch.where(parked, gid, PAD)]
            lo_r, hi_r = _seg_windows(seg, R)
            for direction, dmask, present in (
                    ("out", wave["is_out"], wave["any_out"]),
                    ("in", ~wave["is_out"], wave["any_in"])):
                if not present:
                    continue
                m = live & act_s & dmask[segc]
                indptr, nbr, typ, ecre, edel = edges_mod._csr_arrays(
                    store, direction)
                safe_g = torch.where(m, gid, 0)
                shard = safe_g % S
                iprow = shard * (cap_v + 1) + safe_g // S
                start = indptr[iprow] + shard * cap_e
                deg = (indptr[iprow + 1] - indptr[iprow]) * m
                # per-unit expand budget: the same §3.4 flag per-query mode
                # raises, so flags agree whenever the shared pools idle
                segdeg = torch.zeros((R + 1,), dtype=torch.int32,
                                     device=device).index_add_(0, segc, deg)
                failed_r = failed_r | (segdeg[:R] > E)
                # shared-pool truncation: flag every owner it touches
                es_f = _flag_segs(zero_r, m & (torch.cumsum(
                    deg, 0, dtype=torch.int32) > ES), segc, R)
                failed_r = failed_r | es_f
                shared_r = shared_r | es_f
                out_n, item = _expand_flat(
                    start, deg, (nbr, typ, ecre, edel),
                    wave["etype_x"][segc], ts_x[segc], ES, backend)
                out_s = torch.where(out_n >= 0, segc[item].to(torch.int32),
                                    R)
                dslot, dnbr, dtyp, dcre, ddel = window_shard_major(
                    edges_mod._delta_arrays(store, direction),
                    S, cfg.cap_delta, dwin)
                ds, dn = _delta_flat(gid, m, lo_r, hi_r, dslot * S + d_shard,
                                     dnbr, dtyp, dcre, ddel, wave["etype"],
                                     ts_r, R, backend)
                parts_s += [out_s, ds]
                parts_g += [out_n, dn]
            cand_s = torch.cat(parts_s)
            cand_g = torch.cat(parts_g)
            del parts_s, parts_g
            seg, gid, fu, fs = _dedup_pairs(cand_s, cand_g, cand_s < R,
                                            R, F, FS, backend)
            failed_r = failed_r | fu | fs
            shared_r = shared_r | fs
            live = seg < R
            segc = torch.clamp(seg, max=R).long()
            rows = cfg.row_of_gid(torch.where(live, gid, 0))
            live = live & _check_flat(store, rows, live, ts_x[segc],
                                      wave["tvt_x"][segc], wave["preds"],
                                      segc)

        # ---- merge units -> queries --------------------------------------
        if has_star:
            qf, gf, live = _merge_flat(seg, gid, live, row2q_x, nbr_x, Q, FS,
                                       backend)
        else:          # chains: seg == query index, pairs already sorted
            qf, gf = torch.clamp(seg, max=Q), gid
        failed_q = _segment_count(failed_r, row2q, Q) > 0
        shared_q = _segment_count(shared_r, row2q, Q) > 0

        # ---- terminal wave ------------------------------------------------
        qc = torch.clamp(qf, max=Q).long()
        if final_preds:
            ts_qx = torch.cat([ts_q, ts_q.new_zeros((1,))])
            rows = cfg.row_of_gid(torch.where(live, gf, 0))
            live = live & _check_flat(store, rows, live, ts_qx[qc],
                                      torch.full_like(rows, -1), final_preds,
                                      qc)
        cur_x = torch.cat([cur_q, cur_q.new_full((1,), -1)])
        live = live & (gf > cur_x[qc])          # gid-cursor continuations
        out = {"failed_q": failed_q, "shared_q": shared_q}
        if terminal == "count":
            out["counts"] = _segment_count(
                live, torch.where(live, qf, Q).long(), Q)
        else:
            rows_gid, attrs, trunc = build_select(
                store, cfg, plans[0], torch.where(live, qf, _NULL),
                torch.where(live, gf, _NULL), live, ts_q[:, None], Q, K)
            out.update(rows_gid=rows_gid, attrs=attrs, truncated=trunc)
        return out

    _cache_put(key, run)
    return run


# ---------------------------------------------------------------------------
# the SPMD shared-frontier program
# ---------------------------------------------------------------------------

def _sort3(a, b, c, n_b: int):
    """``jax.lax.sort((a, b, c), num_keys=3)`` for ``a`` >= 0 small, ``b``
    in [0, n_b) and ``c`` any int32: one sort of a packed int64 key."""
    packed = torch.sort(((a.long() * n_b + b.long()) << 32)
                        + (c.long() + 2**31)).values
    hi = packed >> 32
    return ((hi // n_b).to(torch.int32), (hi % n_b).to(torch.int32),
            ((packed & 0xFFFFFFFF) - 2**31).to(torch.int32))


def _bucket_flat(seg, gid, m, S: int, SB: int, R: int):
    """One shard's shared RPC buckets: live pairs sorted by (owner, seg,
    gid) into (S, SB) slots shared by every unit; a dropped pair flags its
    owner segment.  Returns (bucket segs, bucket gids, failed_seg)."""
    N = seg.shape[0]
    dev = seg.device
    ow_s, s_s, g_s = _sort3(torch.where(m, gid % S, S),
                            torch.where(m, seg, R), torch.where(m, gid, PAD),
                            R + 1)
    starts = torch.searchsorted(
        ow_s, torch.arange(S, dtype=ow_s.dtype, device=dev), out_int32=True)
    col = torch.arange(N, dtype=torch.int32, device=dev) - starts[
        torch.clamp(ow_s, max=S - 1)]
    ok = ow_s < S
    failed = _flag_segs(torch.zeros((R,), dtype=torch.bool, device=dev),
                        ok & (col >= SB), torch.clamp(s_s, max=R), R)
    keep = ok & (col < SB)
    flat = torch.where(keep, ow_s * SB + col, S * SB)
    return (_scatter_drop(S * SB, flat, s_s, R),
            _scatter_drop(S * SB, flat, g_s, PAD), failed)


def _route_flat(segs, gids, ms, S: int, SB: int, R: int):
    """Shared-bucket routing on per-shard lists: flat pairs -> all_to_all
    -> (S*SB,) arrivals; returns per-shard (seg', gid', failed_seg)."""
    bs, bg, failed = zip(*(_bucket_flat(s, g, m, S, SB, R)
                           for s, g, m in zip(segs, gids, ms)))
    return (mesh_mod.all_to_all(list(bs)), mesh_mod.all_to_all(list(bg)),
            list(failed))


def compile_batch_shared_spmd(cfg: StoreConfig, plans: tuple,
                              caps: QueryCaps, mesh,
                              backend: backend_mod.Backend = backend_mod.REF,
                              dwin: Optional[int] = None,
                              xwin: Optional[int] = None,
                              vwin: Optional[int] = None):
    """Shared-frontier waves on a shard mesh: the §3.4 coordinator/worker
    protocol with one shared (seg, gid) pool a shard, the routing buckets
    ``SB = shared_budget(R, caps.bucket)`` a destination shared by every
    unit; the contract of :func:`compile_batch_shared`."""
    from repro_torch.core.query.executor_spmd import (_lookup_local,
                                                      select_shard_major)

    dwin = cfg.cap_delta if dwin is None else min(dwin, cfg.cap_delta)
    key = (cfg, plans, caps, len(plans), mesh, backend, dwin, xwin, vwin,
           "shared-spmd")
    fn = _cache_get(key)
    if fn is not None:
        return fn

    Q = len(plans)
    F, E, B, K = caps.frontier, caps.expand, caps.bucket, caps.results
    S = cfg.n_shards
    chains, row2q_np, n_br_np, _ = _unit_tables(plans)
    R = len(chains)
    FS = shared_budget(R, F, caps.shared_frontier)
    ES = shared_budget(R, E, caps.shared_expand)
    SB = shared_budget(R, B, caps.shared_bucket)
    if FS < R:
        raise ValueError(f"shared frontier budget {FS} below unit count {R}")
    has_star = any(p.is_intersect for p in plans)
    waves_np = _wave_tables(chains)
    terminal = plans[0].terminal
    select = tuple(zip(plans[0].select_kind, plans[0].select_cols))
    kvec_np, has_nearest, KMAX = _nearest_tables(chains, F)
    vw = (min(cfg.cap_vec if vwin is None else vwin, cfg.cap_vec)
          if has_nearest else 0)
    pend_tvt, pend_preds, fin_tvt, fin_preds = _spmd_pending(
        chains, waves_np, R)

    def tables(device):
        """The static tables on one device, per-unit tables extended by the
        ghost segment."""
        def dev_t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def dev_preds(groups):
            return [(pred, dev_t(_ext(mask, False))) for pred, mask in groups]
        return dict(
            row2q=dev_t(row2q_np, torch.int64),
            row2q_x=dev_t(np.concatenate([row2q_np, [Q]]), torch.int32),
            nbr_x=dev_t(np.concatenate([n_br_np, [-1]]), torch.int32),
            start_vt=dev_t([c.start_vtype for c in chains], torch.int32),
            unit_ids=torch.arange(R, dtype=torch.int32, device=device),
            waves=[dict(act=dev_t(_ext(w.act, False)),
                        is_out=dev_t(_ext(w.is_out, False)),
                        etype=dev_t(w.etype, torch.int32),
                        etype_x=dev_t(_ext(w.etype, -1), torch.int32),
                        tvt_x=dev_t(_ext(pend_tvt[i], -1), torch.int32),
                        preds=dev_preds(pend_preds[i]),
                        any_out=w.any_out, any_in=w.any_in)
                   for i, w in enumerate(waves_np)],
            fin_tvt_x=dev_t(_ext(fin_tvt, -1), torch.int32),
            fin_preds=dev_preds(fin_preds),
            final_preds=dev_preds(_final_pred_groups(plans)),
            nmask=dev_t(kvec_np > 0), kvec=dev_t(kvec_np, torch.int32),
            colk=torch.arange(KMAX, dtype=torch.int32,
                              device=device)[None, :],
            zero_r=torch.zeros((R,), dtype=torch.bool, device=device))
    tabs = {d: tables(d) for d in set(mesh.devices)}

    def run(store, keys, vecs, valid_in, ts_q, cur_q):
        sts = mesh_mod.shard_store(store, cfg, mesh)
        T = [tabs[d] for d in mesh.devices]
        keys_l, valid_l = mesh.replicate(keys), mesh.replicate(valid_in)
        ts_l, cur_l = mesh.replicate(ts_q), mesh.replicate(cur_q)
        ts_r = [ts[t["row2q"]] for ts, t in zip(ts_l, T)]
        ts_x = [torch.cat([x, x.new_zeros((1,))]) for x in ts_r]
        failed_r = [t["zero_r"] for t in T]
        shared_r = [t["zero_r"] for t in T]   # the subset the pools caused
        # ---- lookup wave ------------------------------------------------
        cands = []
        for me, (st, t) in enumerate(zip(sts, T)):
            look_ok = (valid_l[me] & ~t["nmask"] if has_nearest
                       else valid_l[me])
            g0 = _lookup_local(st, cfg, me, t["start_vt"], keys_l[me],
                               look_ok, ts_r[me], backend, xd_win=xwin)
            cands.append((torch.where(g0 >= 0, t["unit_ids"], R),
                          torch.where(g0 >= 0, g0, PAD)))
        if has_nearest:
            # the distributed k-NN probe of planner.compile_batch_spmd;
            # each shard's seeds join its flat pool
            vecs_l = mesh.replicate(vecs)
            dd, gg = zip(*(backend_mod.knn_topk(
                vecs_l[me], st.vx_emb[:vw], st.vx_gid[:vw],
                st.vx_vtype[:vw], st.vx_create[:vw], st.vx_delete[:vw],
                t["start_vt"], ts_r[me], KMAX, backend=backend)
                for me, (st, t) in enumerate(zip(sts, T))))
            ads, ags = mesh_mod.all_gather(list(dd)), mesh_mod.all_gather(
                list(gg))
            for me, t in enumerate(T):
                gsel = _knn_merge(ads[me], ags[me], R)[:, :KMAX]
                seeds_ok = (t["nmask"][:, None]
                            & (t["colk"] < t["kvec"][:, None])
                            & (gsel != I32MAX) & valid_l[me][:, None]
                            & ((gsel % S) == me))
                seg_n = torch.where(seeds_ok, t["unit_ids"][:, None], R)
                cands[me] = (torch.cat([cands[me][0], seg_n.reshape(-1)]),
                             torch.cat([cands[me][1], torch.where(
                                 seeds_ok, gsel, PAD).reshape(-1)]))
        seg, gid = [], []
        for me, (cs, cg) in enumerate(cands):
            sg, gd, fu, fs = _dedup_pairs(cs, cg, cs < R, R, F, FS, backend)
            failed_r[me] = failed_r[me] | fu | fs
            shared_r[me] = shared_r[me] | fs
            seg.append(sg)
            gid.append(gd)

        for w in range(len(waves_np)):
            live = [sg < R for sg in seg]
            act_s = [t["waves"][w]["act"][torch.clamp(sg, max=R).long()]
                     for sg, t in zip(seg, T)]
            # 1) batched RPCs (bucket drops are a shared-capacity casualty)
            a_s, a_g, fr = _route_flat(seg, gid, [lv & a for lv, a in
                                                  zip(live, act_s)], S, SB, R)
            for me, (st, t) in enumerate(zip(sts, T)):
                wave = t["waves"][w]
                # parked pairs stay put until the final routing
                parked = live[me] & ~act_s[me]
                parts_s = [torch.where(parked, seg[me], R)]
                parts_g = [torch.where(parked, gid[me], PAD)]
                seg_a, gid_a, fu, fs = _dedup_pairs(
                    a_s[me], a_g[me], a_s[me] < R, R, F, FS, backend)
                failed_r[me] = failed_r[me] | fr[me] | fu | fs
                shared_r[me] = shared_r[me] | fr[me] | fs
                live_a = seg_a < R
                segc_a = torch.clamp(seg_a, max=R).long()
                # 2) owner-side pending checks (the previous hop's)
                alive = live_a & _check_flat(
                    st, torch.where(live_a, gid_a // S, 0), live_a,
                    ts_x[me][segc_a], wave["tvt_x"][segc_a], wave["preds"],
                    segc_a)
                lo_r, hi_r = _seg_windows(seg_a, R)
                # 3) worker step: my CSR block + delta log
                for direction, dmask, present in (
                        ("out", wave["is_out"], wave["any_out"]),
                        ("in", ~wave["is_out"], wave["any_in"])):
                    if not present:
                        continue
                    m = alive & wave["act"][segc_a] & dmask[segc_a]
                    indptr, nbr, typ, ecre, edel = edges_mod._csr_arrays(
                        st, direction)
                    delta = edges_mod._delta_arrays(st, direction)
                    slot = torch.where(m, gid_a // S, 0)
                    start = indptr[slot]
                    deg = (indptr[slot + 1] - indptr[slot]) * m
                    segdeg = torch.zeros((R + 1,), dtype=torch.int32,
                                         device=deg.device).index_add_(
                        0, segc_a, deg)
                    failed_r[me] = failed_r[me] | (segdeg[:R] > E)
                    es_f = _flag_segs(t["zero_r"], m & (torch.cumsum(
                        deg, 0, dtype=torch.int32) > ES), segc_a, R)
                    failed_r[me] = failed_r[me] | es_f
                    shared_r[me] = shared_r[me] | es_f
                    out_n, item = _expand_flat(
                        start, deg, (nbr, typ, ecre, edel),
                        wave["etype_x"][segc_a], ts_x[me][segc_a], ES,
                        backend)
                    out_s = torch.where(out_n >= 0,
                                        segc_a[item].to(torch.int32), R)
                    # my delta block is one shard: window [:dwin]; my pairs
                    # all live here, so gid // S is the local slot and stays
                    # ascending within each segment's run
                    dslot, dnbr, dtyp, dcre, ddel = (a[:dwin] for a in delta)
                    ds, dn = _delta_flat(
                        torch.where(live_a, gid_a // S, PAD), m, lo_r, hi_r,
                        dslot, dnbr, dtyp, dcre, ddel, wave["etype"],
                        ts_r[me], R, backend)
                    parts_s += [out_s, ds]
                    parts_g += [out_n, dn]
                cand_s = torch.cat(parts_s)
                cand_g = torch.cat(parts_g)
                seg[me], gid[me], fu, fs = _dedup_pairs(
                    cand_s, cand_g, cand_s < R, R, F, FS, backend)
                failed_r[me] = failed_r[me] | fu | fs
                shared_r[me] = shared_r[me] | fs

        # ---- finalize: route all, owed checks, merge, aggregate -----------
        a_s, a_g, fr = _route_flat(seg, gid, [sg < R for sg in seg], S, SB,
                                   R)
        fin = []
        for me, (st, t) in enumerate(zip(sts, T)):
            sg, gd, fu, fs = _dedup_pairs(a_s[me], a_g[me], a_s[me] < R, R,
                                          F, FS, backend)
            failed_r[me] = failed_r[me] | fr[me] | fu | fs
            shared_r[me] = shared_r[me] | fr[me] | fs
            live = sg < R
            segc = torch.clamp(sg, max=R).long()
            live = live & _check_flat(
                st, torch.where(live, gd // S, 0), live, ts_x[me][segc],
                t["fin_tvt_x"][segc], t["fin_preds"], segc)
            # the intersect-merge is shard-local (one owner a gid)
            if has_star:
                qf, gf, live = _merge_flat(sg, gd, live, t["row2q_x"],
                                           t["nbr_x"], Q, FS, backend)
            else:
                qf, gf = torch.clamp(sg, max=Q), gd
            qc = torch.clamp(qf, max=Q).long()
            ts_qx = torch.cat([ts_l[me], ts_l[me].new_zeros((1,))])
            if t["final_preds"]:
                live = live & _check_flat(
                    st, torch.where(live, gf // S, 0), live, ts_qx[qc],
                    torch.full(qc.shape, -1, dtype=torch.int32,
                               device=qc.device), t["final_preds"], qc)
            cur_x = torch.cat([cur_l[me], cur_l[me].new_full((1,), -1)])
            live = live & (gf > cur_x[qc])      # gid-cursor continuations
            fin.append((qf, gf, live,
                        _segment_count(failed_r[me], t["row2q"], Q),
                        _segment_count(shared_r[me], t["row2q"], Q)))
        out = {"failed_q": mesh_mod.psum([x[3] for x in fin])[0] > 0,
               "shared_q": mesh_mod.psum([x[4] for x in fin])[0] > 0}
        if terminal == "count":
            out["counts"] = mesh_mod.psum([
                _segment_count(lv, torch.where(lv, qf, Q), Q)
                for qf, _, lv, _, _ in fin])[0]
            return out
        # select: rows shard-major, each at its query's snapshot
        out.update(select_shard_major(
            sts, cfg, [(torch.where(lv, qf, _NULL), torch.where(lv, gf, _NULL),
                        lv) for qf, gf, lv, _, _ in fin], ts_l, Q, K, select))
        return out

    _cache_put(key, run)
    return run
