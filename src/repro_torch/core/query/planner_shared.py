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
the ``sorted_lookup`` kernel.  The SPMD program is a later slice.
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
                                            _final_pred_groups,
                                            _nearest_tables, _unit_tables,
                                            _wave_tables, shared_budget)
from repro_torch.core.store import visible, window_shard_major

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
