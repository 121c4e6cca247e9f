"""Multi-query planner: fused operator waves across plan shapes (§3.4, §5).

Port of the local path of ``repro/core/query/planner.py``.  A batch of A1QL
plans — chains and star patterns — sharing a terminal signature and caps
runs as one fused wave program over the R *chain units* (a chain is one
unit, a star one unit per branch):

  * lookup wave — every unit's start probe in one ``index.lookup`` call,
    and for ``Nearest``-rooted units one k-NN probe (``knn_topk``) over the
    vector index, whose seeds become the unit's first frontier;
  * hop wave k — every unit with a k-th hop expands its frontier region in
    one tile plan per direction; per-unit edge types and snapshots are
    vectors; finished units are parked and ride along;
  * intersect-merge wave — each star's branch regions fold into one query
    region (a sort plus run lengths keeps gids reached by every branch).

The frontier is an (R, frontier) matrix whose row r holds unit r's
sorted-unique gids, so every query keeps its own §3.4 budget and snapshot
and its results (fast-fail flags included) equal a solo run.
``budget="shared"`` runs the flat shared-pool programs of
:mod:`repro_torch.core.query.planner_shared` instead; grouping, caching and
the assembly are shared.  Under ``mesh=`` (:func:`compile_batch_spmd`) the
same waves run as the §3.4 query-shipping protocol over the shards of a
``ShardMesh``: each wave routes the active pairs to their owners (one
``all_to_all``), the owner runs the previous hop's vertex checks and
expands from its own block, and the results aggregate with ``psum``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import edges as edges_mod
from repro_torch.core import index as index_mod
from repro_torch.core.addressing import NULL, StoreConfig
from repro_torch.core.edges import TILE
from repro_torch.core.query.a1ql import Plan
from repro_torch.core.query.executor import (I32MAX, QueryCaps, QueryResult,
                                             _scatter_drop, eval_pred,
                                             select_attrs)
from repro_torch.core.query.executor_spmd import _lookup_local, stable_sort_by
from repro_torch.core.store import visible, window_shard_major
from repro_torch.dist import mesh as mesh_mod

PAD = I32MAX    # empty frontier slot; sorts last, keeps rows ascending
_NULL = int(NULL)


# ---------------------------------------------------------------------------
# static wave tables (host-side, derived from the plan tuple)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Wave:
    """Per-wave static tables: one entry per chain unit in the batch."""
    act: np.ndarray        # (R,) bool  — unit has a hop at this wave
    is_out: np.ndarray     # (R,) bool  — hop direction (False = 'in')
    etype: np.ndarray      # (R,) i32   — edge type to follow (-1 = any)
    tvt: np.ndarray        # (R,) i32   — target vtype check (-1 = none)
    preds: list            # [(Pred, (R,) bool mask)] — hop predicates
    any_out: bool
    any_in: bool


def _pred_groups(entries) -> list:
    """Group (row_index, Pred) pairs by identical predicate."""
    groups: dict = {}
    for qi, pred, n in entries:
        groups.setdefault(pred, np.zeros(n, bool))[qi] = True
    return list(groups.items())


def _wave_tables(chains: Sequence[Plan]) -> list[_Wave]:
    R = len(chains)
    W = max(len(p.hops) for p in chains)
    waves = []
    for w in range(W):
        act = np.array([len(p.hops) > w for p in chains])
        is_out = np.array([len(p.hops) > w and p.hops[w].direction == "out"
                           for p in chains])
        etype = np.array([p.hops[w].etype if len(p.hops) > w else -1
                          for p in chains], np.int32)
        tvt = np.array([p.hops[w].target_vtype if len(p.hops) > w else -1
                        for p in chains], np.int32)
        preds = _pred_groups([(ri, p.hops[w].pred, R)
                              for ri, p in enumerate(chains)
                              if len(p.hops) > w and p.hops[w].pred])
        waves.append(_Wave(act=act, is_out=is_out, etype=etype, tvt=tvt,
                           preds=preds, any_out=bool((act & is_out).any()),
                           any_in=bool((act & ~is_out).any())))
    return waves


def _final_pred_groups(plans: Sequence[Plan]) -> list:
    return _pred_groups([(qi, p.final_pred, len(plans))
                         for qi, p in enumerate(plans) if p.final_pred])


def _unit_tables(plans: Sequence[Plan]):
    """Flatten per-query plans into chain units + the query<->row maps.

    Returns (chains, row2q, n_br, rows_of_q) where ``rows_of_q[q]`` lists
    query q's unit rows padded with R (the all-PAD ghost row)."""
    chains, row2q = [], []
    for qi, p in enumerate(plans):
        for br in p.chain_units():
            chains.append(br)
            row2q.append(qi)
    R = len(chains)
    n_br = np.asarray([len(p.chain_units()) for p in plans], np.int32)
    rows_of_q = np.full((len(plans), int(n_br.max())), R, np.int32)
    r = 0
    for qi, p in enumerate(plans):
        for bi in range(int(n_br[qi])):
            rows_of_q[qi, bi] = r
            r += 1
    return chains, np.asarray(row2q, np.int32), n_br, rows_of_q


# ---------------------------------------------------------------------------
# fused wave primitives
# ---------------------------------------------------------------------------

def _scatter_rows(n_rows: int, width: int, col, vals, fill):
    """``full((n_rows, width), fill).at[rows, col].set(vals, mode='drop')``
    for col >= 0: one spare column takes the dropped writes."""
    out = torch.full((n_rows, width + 1), fill, dtype=vals.dtype,
                     device=vals.device)
    out.scatter_(1, torch.clamp(col, max=width).long(), vals)
    return out[:, :width]


def _dedup_rows(cand_g, cand_v, F: int,
                backend: backend_mod.Backend = backend_mod.REF):
    """Per-unit dedup/compact: (R, W) candidates -> (R, F) regions holding
    each row's first F unique gids ascending (PAD beyond).  Returns (gids,
    valid, overflow_r)."""
    key = torch.where(cand_v, cand_g, PAD).contiguous()
    g, n_q = backend_mod.dedup_compact_rows(key, F, backend=backend)
    return g, g != PAD, n_q > F


def _expand_rows(start, deg, pools, et_q, ts_q, E: int,
                 backend: backend_mod.Backend):
    """Fused CSR expansion: (R, F) spans -> (R, E) neighbor matrix.

    Row r receives the first E raw span entries of unit r's frontier —
    masked by per-unit MVCC visibility (``ts_q``) and edge type (``et_q``)
    — at exactly the positions the per-query reference path computes, so
    both backends emit the same buffers (a per-unit budget clamp on the
    tile plan makes even the overflow truncation match)."""
    nbr, typ, ecre, edel = pools
    R, F = deg.shape
    dev = deg.device
    cum = torch.cumsum(deg, 1, dtype=torch.int32)
    excl = cum - deg
    if backend.is_kernel:
        # one tile plan for the whole wave; each unit's span budget is
        # clamped to its remaining E so no unit can starve another's tiles
        deg_eff = torch.minimum(torch.clamp(E - excl, min=0), deg)
        cap_tiles = R * (min(F, E) + 1 + (E + TILE - 1) // TILE)
        (nbr_t, typ_t, cre_t, del_t), item, tw, _ = backend_mod.expand_tiles(
            start.reshape(-1).contiguous(), deg_eff.reshape(-1).contiguous(),
            pools, tile=TILE, cap_tiles=cap_tiles)
        item_c = torch.clamp(item, max=R * F - 1)
        row = item_c // F
        lane = torch.arange(TILE, dtype=torch.int32, device=dev)
        shape = (cap_tiles, TILE)
        nbr_t, typ_t = nbr_t.reshape(shape), typ_t.reshape(shape)
        cre_t, del_t = cre_t.reshape(shape), del_t.reshape(shape)
        et_t = et_q[row][:, None]
        # invalid lanes carry -1 in every pool: visible(-1,-1,ts) is False
        e_ok = (visible(cre_t, del_t, ts_q[row][:, None])
                & ((et_t < 0) | (typ_t == et_t)) & (nbr_t >= 0))
        posq = (excl.reshape(-1)[item_c][:, None] + tw[:, None] * TILE
                + lane[None, :])
        pos = torch.where(e_ok & (posq < E), row[:, None] * E + posq, R * E)
        out = torch.full((R * E + 1,), _NULL, dtype=torch.int32, device=dev)
        out[pos.reshape(-1)] = nbr_t.reshape(-1)
        return out[:R * E].reshape(R, E)

    k = torch.arange(E, dtype=torch.int32, device=dev)
    item = torch.searchsorted(cum, k[None, :].expand(R, E).contiguous(),
                              right=True, out_int32=True)
    item_c = torch.clamp(item, max=F - 1).long()
    base = cum.gather(1, item_c) - deg.gather(1, item_c)
    in_range = k[None, :] < cum[:, -1:]
    epos = torch.where(in_range, start.gather(1, item_c) + (k[None, :] - base),
                       0)
    n_e = nbr[epos]
    et = et_q[:, None]
    e_ok = (in_range & visible(ecre[epos], edel[epos], ts_q[:, None])
            & ((et < 0) | (typ[epos] == et)) & (n_e >= 0))
    return torch.where(e_ok, n_e, _NULL)


def _delta_rows(key_rows, m, d_key, dnbr, dtyp, dcre, ddel, et_q, ts_q):
    """Per-unit delta-log matches: (R, F) regions x (D,) log -> (R, D).

    Frontier regions hold sorted-unique keys, so each delta entry matches at
    most one slot per unit — a row-wise binary search replaces the (F x D)
    match matrix of the single-query path, with the same match sets."""
    R, F = key_rows.shape
    pos = torch.searchsorted(key_rows.contiguous(),
                             d_key[None, :].expand(R, -1).contiguous(),
                             out_int32=True)
    pos_c = torch.clamp(pos, max=F - 1).long()
    at_k = key_rows.gather(1, pos_c)
    at_m = m.gather(1, pos_c)
    hit = (at_m & (at_k == d_key[None, :])
           & (dnbr >= 0)[None, :]
           & visible(dcre[None, :], ddel[None, :], ts_q[:, None])
           & ((et_q[:, None] < 0) | (dtyp[None, :] == et_q[:, None])))
    return torch.where(hit, dnbr[None, :], _NULL)


def _fit_delta(dn, row_w: int, backend: backend_mod.Backend):
    """A wave's candidate rows, ``row_w`` columns, must fit the dedup
    kernel's ``DEDUP_MAX_W``.  With full delta logs they do not: F + 2 (E +
    delta window), 69,632 columns at the a1-kg caps.  Then the delta
    matches ``dn`` (NULL where none) are packed left and cut to the most
    any row holds (one host read of that count).  The dedup depends on
    neither the candidates' order nor the NULL columns, so the regions are
    the same; the ref backend takes any width and is not packed."""
    if not backend.is_kernel or row_w <= backend_mod.DEDUP_MAX_W:
        return dn
    R = dn.shape[0]
    hit = dn >= 0
    pos = torch.cumsum(hit, dim=1, dtype=torch.int32) - 1
    W = max(int(pos[:, -1].max()) + 1, 1) if R else 1
    out = torch.full((R, W + 1), _NULL, dtype=dn.dtype, device=dn.device)
    out.scatter_(1, torch.where(hit, pos, W).long(), dn)
    return out[:, :W]


def _check_rows(st, rows, valid, ts_q, tvt_q, preds):
    """Fused liveness/type/predicate check on (R, F) frontier regions;
    ``tvt_q``/``preds`` are per-unit tables (parked units carry -1 / no
    predicate, so only the idempotent liveness check applies to them)."""
    ts2 = ts_q[:, None]
    alive = valid & visible(st.v_create[rows], st.v_delete[rows], ts2)
    tvt2 = tvt_q[:, None]
    alive = alive & ((tvt2 < 0) | (st.vtype[rows] == tvt2))
    if preds:
        use_cur = (st.vdata_ts[rows] <= ts2)[..., None]
        f = torch.where(use_cur, st.vdata_f[rows], st.vprev_f[rows])
        i = torch.where(use_cur, st.vdata_i[rows], st.vprev_i[rows])
        keys = st.vkey[rows]
        for pred, qmask in preds:
            pm = qmask[:, None]
            alive = alive & (~pm | eval_pred(pred, f, i, keys))
    return alive


def _merge_rows(g, valid, n_br, rows_of_q, F: int,
                backend: backend_mod.Backend = backend_mod.REF):
    """The intersect-merge wave: (R, F) unit regions -> (Q, F) query regions.

    Each query keeps the gids present in every one of its branch rows (run
    length == branch count after a sort of the gathered rows; branch rows
    are sorted-unique).  The merged region cannot overflow."""
    Q, Bmax = rows_of_q.shape
    gp = torch.cat([torch.where(valid, g, PAD),
                    torch.full((1, F), PAD, dtype=torch.int32,
                               device=g.device)])
    key = gp[rows_of_q].reshape(Q, Bmax * F)
    key_s = backend_mod.sort_rows(key, backend=backend)
    valid_s = key_s != PAD
    prev = torch.cat([torch.full((Q, 1), -1, dtype=torch.int32,
                                 device=g.device), key_s[:, :-1]], dim=1)
    first = valid_s & (key_s != prev)
    lo = torch.searchsorted(key_s, key_s, out_int32=True)
    hi = torch.searchsorted(key_s, key_s, right=True, out_int32=True)
    keep = first & ((hi - lo) == n_br[:, None])
    ki = keep.to(torch.int32)
    col = torch.where(keep, torch.cumsum(ki, 1, dtype=torch.int32) - ki,
                      Bmax * F)
    out = _scatter_rows(Q, F, col, key_s, PAD)
    return out, out != PAD


def _select_rows(st, cfg, g, valid, ts_q, select, K: int):
    """Fused select terminal: (Q, F) regions -> (Q, K) rows + attrs."""
    vi = valid.to(torch.int32)
    rank = torch.cumsum(vi, 1, dtype=torch.int32) - vi
    over = valid & (rank >= K)
    col = torch.where(valid & ~over, rank, K)
    rows_gid = _scatter_rows(g.shape[0], K, col,
                             torch.where(valid, g, _NULL), _NULL)
    attrs = select_attrs(st, cfg, rows_gid, ts_q[:, None], select)
    return rows_gid, attrs, over.any(dim=1)


# ---------------------------------------------------------------------------
# the local fused program
# ---------------------------------------------------------------------------

# one program per batch *shape* (tuple of plans), LRU-bounded: batch shapes
# are combinatorial
_CACHE: collections.OrderedDict = collections.OrderedDict()
CACHE_MAX_PROGRAMS = 256


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


# peak frontier footprint (bytes) of the programs executed so far, per
# budget mode — the memory claim of the shared-frontier mode
FRONTIER_STATS = {"per_query_peak_bytes": 0, "shared_peak_bytes": 0}

# running overflow tallies across every fused dispatch: how many query slots
# fast-failed at all, how many of those the *shared* pools evicted rather
# than their own per-unit budget, and how many a deadline skipped
OVERFLOW_STATS = {"failed_queries": 0, "shared_ovf_queries": 0,
                  "deadline_skipped_queries": 0}


def reset_stats() -> None:
    """Zero the observability counters (not the program cache): they are
    process-global, so a fresh database or benchmark run resets them."""
    for d in (FRONTIER_STATS, OVERFLOW_STATS):
        for k in d:
            d[k] = 0


def _ceil_sqrt(n: int) -> int:
    import math
    return math.isqrt(max(0, int(n) - 1)) + 1


def shared_budget(n_units: int, per_cap: int, explicit: int = 0) -> int:
    """The shared-capacity policy: ``per_cap * ceil(sqrt(R))``, at least R
    (one slot a unit) and at most ``R * per_cap`` (never more than the
    per-query footprint).  ``explicit`` (``QueryCaps.shared_*``) overrides
    the policy, clamped to the per-query footprint."""
    r = max(1, int(n_units))
    if explicit:
        return min(int(explicit), r * per_cap)
    return min(r * per_cap, max(per_cap * _ceil_sqrt(r), r))


def delta_window(db) -> int:
    """Static per-shard edge-delta-log window for the next fused program:
    the delta logs fill prefix-first per shard (host count mirrors are
    exact), so scanning ``[:W]`` of each shard block sees every live entry.
    Rounded to a power of two and clamped."""
    n = int(max(db.dl_count.max(initial=0), db.il_count.max(initial=0), 1))
    return min(_pow2ceil(n), db.cfg.cap_delta)


def index_window(db) -> int:
    """Static per-shard primary-index delta window (same contract as
    :func:`delta_window`, for the ``index.lookup`` delta scan)."""
    n = int(max(db.xd_count.max(initial=0), 1))
    return min(_pow2ceil(n), db.cfg.cap_idx_delta)


def _nearest_tables(chains, F: int):
    """Static k-NN probe tables: per-unit k (0 = scan-rooted), whether any
    unit is Nearest-rooted, the batch KMAX, and the ``k <= frontier``
    check."""
    kvec = np.array([c.nearest_k for c in chains], np.int32)
    has_nearest = bool((kvec > 0).any())
    kmax = int(kvec.max()) if has_nearest else 0
    if kmax > F:
        raise ValueError(f"nearest k={kmax} exceeds the frontier cap {F}; "
                         "raise caps.frontier (or the 'frontier' hint)")
    return kvec, has_nearest, kmax


def _cache_get(key):
    fn = _CACHE.get(key)
    if fn is not None:
        _CACHE.move_to_end(key)
    return fn


def _cache_put(key, fn) -> None:
    _CACHE[key] = fn
    while len(_CACHE) > CACHE_MAX_PROGRAMS:
        _CACHE.popitem(last=False)


def compile_batch(cfg: StoreConfig, plans: tuple, caps: QueryCaps,
                  backend: backend_mod.Backend = backend_mod.REF,
                  dwin: Optional[int] = None, xwin: Optional[int] = None,
                  vwin: Optional[int] = None, device="cpu"):
    """The fused-wave program for one batch shape:
    ``run(store, keys, vecs, valid_in, ts_q, cur_q)``.

    ``plans`` is a tuple of logical plans (chains and/or stars) sharing a
    terminal signature; start keys (one per chain unit, branch-major per
    query), per-query snapshots and gid cursors stay runtime tensors.
    ``dwin``/``xwin`` are the edge / primary-index delta windows; ``vwin``
    is the vector-index window (``vindex.vindex_window``), used only when a
    unit is ``Nearest``-rooted: ``vecs`` then holds one (d_f32,) query
    vector per unit (zeros for scan-rooted units), else it is ``None``."""
    from repro_torch.core import vindex as vindex_mod

    dwin = cfg.cap_delta if dwin is None else min(dwin, cfg.cap_delta)
    device = torch.device(device)
    key = (cfg, plans, caps, len(plans), backend, dwin, xwin, vwin,
           str(device), "local")
    fn = _cache_get(key)
    if fn is not None:
        return fn

    Q = len(plans)
    F, E, K = caps.frontier, caps.expand, caps.results
    S, cap_v, cap_e = cfg.n_shards, cfg.cap_v, cfg.cap_e
    chains, row2q_np, n_br_np, rows_of_q_np = _unit_tables(plans)
    R = len(chains)
    has_star = any(p.is_intersect for p in plans)
    terminal = plans[0].terminal
    select = tuple(zip(plans[0].select_kind, plans[0].select_cols))

    def dev_t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def dev_preds(groups):
        return [(pred, dev_t(mask)) for pred, mask in groups]

    row2q = dev_t(row2q_np, torch.int64)
    n_br = dev_t(n_br_np, torch.int32)
    rows_of_q = dev_t(rows_of_q_np, torch.int64)
    start_vt = dev_t([c.start_vtype for c in chains], torch.int32)
    waves = [dict(act=dev_t(w.act), is_out=dev_t(w.is_out),
                  etype=dev_t(w.etype, torch.int32),
                  tvt=dev_t(w.tvt, torch.int32), preds=dev_preds(w.preds),
                  any_out=w.any_out, any_in=w.any_in)
             for w in _wave_tables(chains)]
    final_preds = dev_preds(_final_pred_groups(plans))
    no_tvt = torch.full((Q,), -1, dtype=torch.int32, device=device)
    d_shard = torch.arange(S * dwin, dtype=torch.int32, device=device) // dwin
    kvec_np, has_nearest, KMAX = _nearest_tables(chains, F)
    vw = (min(cfg.cap_vec if vwin is None else vwin, cfg.cap_vec)
          if has_nearest else 0)
    nmask = dev_t(kvec_np > 0)
    kvec = dev_t(kvec_np, torch.int32)
    colk = torch.arange(KMAX, dtype=torch.int32, device=device)[None, :]

    def run(store, keys, vecs, valid_in, ts_q, cur_q):
        ts_r = ts_q[row2q]                                  # (R,) per unit
        failed_r = torch.zeros((R,), dtype=torch.bool, device=device)
        # ---- lookup wave: one probe for every chain unit ------------------
        # Nearest-rooted units skip the primary index; their seeds come from
        # the k-NN probe below
        look_ok = valid_in & ~nmask if has_nearest else valid_in
        gids0, found = index_mod.lookup(store, cfg, start_vt, keys, look_ok,
                                        ts_r, backend=backend, xd_win=xwin)
        scan_col = torch.where(found & look_ok, gids0, PAD)
        if has_nearest:
            # ---- k-NN probe wave: one distance + top-KMAX pass over the
            # windowed index; per-unit k masks columns of the shared result,
            # and the dedup lays the seeds out sorted-unique (ties are
            # already gid-ordered by the kernel)
            vx = vindex_mod.window_arrays(store, cfg, vw)
            _, knn_g = backend_mod.knn_topk(vecs, vx[4], *vx[:4], start_vt,
                                            ts_r, KMAX, backend=backend)
            seeds_ok = (nmask[:, None] & (colk < kvec[:, None])
                        & (knn_g != I32MAX) & valid_in[:, None])
            cand = torch.cat([scan_col[:, None],
                              torch.where(seeds_ok, knn_g, PAD)], dim=1)
            g, valid, ovf = _dedup_rows(cand, cand != PAD, F, backend)
            failed_r = failed_r | ovf
        else:
            g = torch.full((R, F), PAD, dtype=torch.int32, device=device)
            g[:, 0] = scan_col
            valid = g != PAD

        for wave in waves:
            act = wave["act"]
            # parked units carry their finished frontier through the wave
            parts_g, parts_v = [g], [valid & ~act[:, None]]
            row_w = F + (wave["any_out"] + wave["any_in"]) * (E + S * dwin)
            for direction, dmask, present in (
                    ("out", wave["is_out"], wave["any_out"]),
                    ("in", ~wave["is_out"], wave["any_in"])):
                if not present:
                    continue
                m = valid & act[:, None] & dmask[:, None]
                indptr, nbr, typ, ecre, edel = edges_mod._csr_arrays(
                    store, direction)
                safe_g = torch.where(m, g, 0)
                shard = safe_g % S
                iprow = shard * (cap_v + 1) + safe_g // S
                start = indptr[iprow] + shard * cap_e
                deg = (indptr[iprow + 1] - indptr[iprow]) * m
                failed_r = failed_r | (deg.sum(1, dtype=torch.int32) > E)
                out_n = _expand_rows(start, deg, (nbr, typ, ecre, edel),
                                     wave["etype"], ts_r, E, backend)
                dslot, dnbr, dtyp, dcre, ddel = window_shard_major(
                    edges_mod._delta_arrays(store, direction),
                    S, cfg.cap_delta, dwin)
                dn = _fit_delta(_delta_rows(g, m, dslot * S + d_shard, dnbr,
                                            dtyp, dcre, ddel, wave["etype"],
                                            ts_r), row_w, backend)
                parts_g += [out_n, dn]
                parts_v += [out_n >= 0, dn >= 0]
            g, valid, ovf = _dedup_rows(torch.cat(parts_g, dim=1),
                                        torch.cat(parts_v, dim=1), F, backend)
            del parts_g, parts_v
            failed_r = failed_r | ovf
            rows = cfg.row_of_gid(torch.where(valid, g, 0))
            valid = valid & _check_rows(store, rows, valid, ts_r, wave["tvt"],
                                        wave["preds"])

        # ---- intersect-merge wave (units -> queries) ----------------------
        if has_star:
            g, valid = _merge_rows(g, valid, n_br, rows_of_q, F, backend)
        failed_q = torch.zeros((Q,), dtype=torch.int32,
                               device=device).index_add_(
            0, row2q, failed_r.to(torch.int32)) > 0

        # ---- terminal wave ------------------------------------------------
        if final_preds:
            rows = cfg.row_of_gid(torch.where(valid, g, 0))
            valid = valid & _check_rows(store, rows, valid, ts_q, no_tvt,
                                        final_preds)
        # gid-cursor continuations: runtime final predicate gid > cursor
        valid = valid & (g > cur_q[:, None])
        out = {"failed_q": failed_q}
        if terminal == "count":
            out["counts"] = valid.sum(1, dtype=torch.int32)
        else:
            rows_gid, attrs, trunc = _select_rows(store, cfg, g, valid, ts_q,
                                                  select, K)
            out.update(rows_gid=rows_gid, attrs=attrs, truncated=trunc)
        return out

    _cache_put(key, run)
    return run


# ---------------------------------------------------------------------------
# host entry points
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.cpu().numpy()


class _Assembly:
    """Scatter per-group results back into input order."""

    def __init__(self, Q: int, K: int):
        self.Q, self.K = Q, K
        self.failed_q = np.zeros(Q, bool)
        # per-query "the shared pool did it" flags: zero for per-query-
        # budget groups, whose failures are always their own
        self.shared_ovf_q = np.zeros(Q, bool)
        self.deadline_q = np.zeros(Q, bool)
        self.counts = None
        self.rows_gid = None
        self.truncated = None
        self.rows: dict = {}

    def _ensure_select(self):
        if self.rows_gid is None:
            self.rows_gid = np.full((self.Q, self.K), _NULL, np.int32)
            self.truncated = np.zeros(self.Q, bool)

    def put(self, idxs, out: dict) -> None:
        self.failed_q[idxs] = _np(out["failed_q"])
        if "shared_q" in out:
            self.shared_ovf_q[idxs] = _np(out["shared_q"])
        if "counts" in out:
            if self.counts is None:
                self.counts = np.full(self.Q, _NULL, np.int32)
            self.counts[idxs] = _np(out["counts"])
        else:
            self._ensure_select()
            rg = _np(out["rows_gid"])
            self.rows_gid[idxs, :rg.shape[1]] = rg
            self.truncated[idxs] = _np(out["truncated"])
            for k, v in out["attrs"].items():
                v0 = _np(v)
                if k not in self.rows:
                    fill = _NULL if k[0] == "key" else 0
                    self.rows[k] = np.full((self.Q, self.K), fill, v0.dtype)
                self.rows[k][idxs, :v0.shape[1]] = v0

    def skip(self, idxs, select: bool) -> None:
        """Mark a group as deadline-truncated without executing it."""
        self.deadline_q[idxs] = True
        if select:
            self._ensure_select()
            self.truncated[idxs] = True

    def result(self) -> QueryResult:
        OVERFLOW_STATS["failed_queries"] += int(self.failed_q.sum())
        OVERFLOW_STATS["shared_ovf_queries"] += int(self.shared_ovf_q.sum())
        OVERFLOW_STATS["deadline_skipped_queries"] += int(
            self.deadline_q.sum())
        return QueryResult(
            counts=self.counts, rows_gid=self.rows_gid,
            rows=self.rows or None, truncated=self.truncated,
            failed=bool(self.failed_q.any()), failed_q=self.failed_q,
            shared_ovf_q=self.shared_ovf_q, deadline_q=self.deadline_q)


def _fusion_groups(lowered, eff_caps):
    """Fusion groups: plans grouped by terminal signature + effective caps,
    each group canonically ordered by plan (any permutation of a batch mix
    resolves to the same program)."""
    groups: dict = {}
    for i, (lo, c) in enumerate(zip(lowered, eff_caps)):
        p = lo.plan
        groups.setdefault((p.terminal, p.select_kind, p.select_cols, c),
                          []).append(i)
    return [(key[3], sorted(idxs, key=lambda i: repr(lowered[i].plan)))
            for key, idxs in groups.items()]


def _has_nearest(plans) -> bool:
    return any(c.nearest_k > 0 for p in plans for c in p.chain_units())


def execute_fused(db, lowered: list, eff_caps: list, ts_list: list[int],
                  be: backend_mod.Backend, mesh=None,
                  budget: str = "per-query",
                  cursors: Optional[Sequence[int]] = None,
                  deadline: Optional[float] = None) -> QueryResult:
    """Run pre-lowered plans as fused multi-query waves.

    With ``budget="per-query"`` every query keeps its own §3.4 budget and
    snapshot, and its results (``failed_q`` flags included) equal running it
    alone.  ``budget="shared"`` runs the shared-frontier programs
    (``planner_shared``): one flat (seg, gid) pool per group with an
    O(F*sqrt(R)) capacity; results can differ from per-query mode only via
    fast-fail flags under shared overflow (``shared_ovf_q``).  ``mesh`` (a
    ``ShardMesh``) runs the SPMD programs of either mode.  ``cursors``
    is the per-query gid cursor (-1 = none); ``deadline`` is an absolute
    ``time.monotonic()`` instant past which a group is skipped and flagged
    ``deadline_q``."""
    from repro_torch.core import vindex as vindex_mod
    from repro_torch.core.query import planner_shared
    Q = len(lowered)
    dev = db.device
    out = _Assembly(Q, max(c.results for c in eff_caps))
    dwin = delta_window(db)
    xwin = index_window(db)
    cursors = [-1] * Q if cursors is None else list(cursors)
    # the vector-index window only enters the cache key of Nearest groups
    vwin = (vindex_mod.vindex_window(db)
            if _has_nearest(lo.plan for lo in lowered) else None)
    for caps_g, idxs in _fusion_groups(lowered, eff_caps):
        plans_g = tuple(lowered[i].plan for i in idxs)
        if deadline is not None and time.monotonic() >= deadline:
            out.skip(idxs, select=plans_g[0].terminal == "select")
            continue
        keys = torch.tensor([k for i in idxs for k in lowered[i].keys],
                            dtype=torch.int32, device=dev)
        ts = torch.tensor([ts_list[i] for i in idxs], dtype=torch.int32,
                          device=dev)
        cur = torch.tensor([cursors[i] for i in idxs], dtype=torch.int32,
                           device=dev)
        R = keys.shape[0]
        vecs, vw_g = None, None
        if _has_nearest(plans_g):
            # (R, d_f32) query vectors, unit-major parallel to ``keys``
            # (zeros for scan-rooted units: their k-NN columns are masked)
            vw_g = vwin
            zero = (0.0,) * db.cfg.d_f32
            vrows = []
            for i in idxs:
                n_units = len(lowered[i].plan.chain_units())
                lv = lowered[i].vecs or (None,) * n_units
                vrows += [zero if v is None else v for v in lv]
            vecs = torch.tensor(np.asarray(vrows, np.float32), device=dev)
        if budget == "shared":
            FS = shared_budget(R, caps_g.frontier, caps_g.shared_frontier)
            FRONTIER_STATS["shared_peak_bytes"] = max(
                FRONTIER_STATS["shared_peak_bytes"], 2 * 4 * FS)
            if mesh is not None:
                fn = planner_shared.compile_batch_shared_spmd(
                    db.cfg, plans_g, caps_g, mesh, be, dwin, xwin, vw_g)
            else:
                fn = planner_shared.compile_batch_shared(
                    db.cfg, plans_g, caps_g, be, dwin, xwin, vw_g, dev)
        else:
            FRONTIER_STATS["per_query_peak_bytes"] = max(
                FRONTIER_STATS["per_query_peak_bytes"],
                4 * R * caps_g.frontier)
            if mesh is not None:
                fn = compile_batch_spmd(db.cfg, plans_g, caps_g, mesh, be,
                                        dwin, xwin, vw_g)
            else:
                fn = compile_batch(db.cfg, plans_g, caps_g, be, dwin, xwin,
                                   vw_g, dev)
        valid = torch.ones((R,), dtype=torch.bool, device=dev)
        out.put(idxs, fn(db.store, keys, vecs, valid, ts, cur))
    return out.result()


# ---------------------------------------------------------------------------
# the SPMD fused program (query shipping, one program per batch shape)
# ---------------------------------------------------------------------------

def _bucket_rows(g, m, S: int, B: int):
    """One shard's fused RPC buckets: (R, F) pairs -> (S, R*B) slots, B per
    (unit, owner), each unit's pairs sorted stably by owner; returns the
    buckets and the per-unit overflow flags."""
    R, F = g.shape
    dev = g.device
    ow_s, g_s = stable_sort_by(torch.where(m, g % S, S), g, dim=1)
    starts = torch.searchsorted(
        ow_s, torch.arange(S, dtype=ow_s.dtype, device=dev)[None, :]
        .expand(R, S).contiguous(), out_int32=True)
    col = (torch.arange(F, dtype=torch.int32, device=dev)[None, :]
           - starts.gather(1, torch.clamp(ow_s, max=S - 1).long()))
    ok = ow_s < S
    overflow_r = (ok & (col >= B)).any(dim=1)
    keep = ok & (col >= 0) & (col < B)
    qcol = (torch.arange(R, dtype=torch.int32, device=dev)[:, None] * B
            + torch.clamp(col, 0, B - 1))
    flat = torch.where(keep, ow_s.long() * (R * B) + qcol, S * R * B)
    return (_scatter_drop(S * R * B, flat.reshape(-1), g_s.reshape(-1),
                          _NULL).reshape(S, R * B), overflow_r)


def _route_rows(gs, ms, S: int, B: int):
    """Fused routing on per-shard lists: (R, F) pairs -> all_to_all ->
    (R, S*B) arrivals.  Buckets are per (unit, owner), so one hot query
    cannot evict another's RPCs.  Returns per-shard (arrived gids, arrived
    mask, overflow_r)."""
    bg, ovf = zip(*(_bucket_rows(g, m, S, B) for g, m in zip(gs, ms)))
    out = []
    for rg in mesh_mod.all_to_all(list(bg)):
        R = rg.shape[1] // B
        out.append(rg.reshape(S, R, B).transpose(0, 1).reshape(R, S * B))
    return out, [a >= 0 for a in out], list(ovf)


def _knn_merge(ad, ag, R: int):
    """The distributed k-NN merge: (S, R, KMAX) per-shard top lists -> (R,
    S*KMAX) gids sorted by (dist, gid) ascending (a stable sort by gid, then
    by distance: -0.0 and +0.0 tie, as in the reference's sort)."""
    ad = ad.transpose(0, 1).reshape(R, -1)
    ag = ag.transpose(0, 1).reshape(R, -1)
    ag, ad = stable_sort_by(ag, ad, dim=1)
    return stable_sort_by(ad, ag, dim=1)[1]


def _spmd_pending(chains, waves, R: int):
    """The owner-side checks each wave owes: wave w validates what wave w-1
    emitted (w = 0 the index scan's start vertices), and the finalize step
    the last hop's; units parked at a wave owe nothing there.  Returns
    (pend_tvt, pend_preds, fin_tvt, fin_preds) as host tables."""
    pend_tvt, pend_preds = [], []
    for w in range(len(waves)):
        if w == 0:
            pend_tvt.append(np.array([c.start_vtype for c in chains],
                                     np.int32))
            pend_preds.append([])
        else:
            pend_tvt.append(np.array(
                [c.hops[w - 1].target_vtype if len(c.hops) > w else -1
                 for c in chains], np.int32))
            pend_preds.append(_pred_groups(
                [(ri, c.hops[w - 1].pred, R) for ri, c in enumerate(chains)
                 if len(c.hops) > w and c.hops[w - 1].pred]))
    # zero-hop units (Nearest-rooted, no chain) owe only the start-type
    # check, which their seeds pass by construction: an idempotent no-op
    fin_tvt = np.array([c.hops[-1].target_vtype if c.hops else c.start_vtype
                        for c in chains], np.int32)
    fin_preds = _pred_groups([(ri, c.hops[-1].pred, R)
                              for ri, c in enumerate(chains)
                              if c.hops and c.hops[-1].pred])
    return pend_tvt, pend_preds, fin_tvt, fin_preds


def compile_batch_spmd(cfg: StoreConfig, plans: tuple, caps: QueryCaps,
                       mesh, backend: backend_mod.Backend = backend_mod.REF,
                       dwin: Optional[int] = None, xwin: Optional[int] = None,
                       vwin: Optional[int] = None):
    """The fused-wave program on a shard mesh: the §3.4 coordinator/worker
    protocol for a whole mixed batch (stars included), with the contract of
    :func:`compile_batch`: ``run(store, keys, vecs, valid_in, ts_q,
    cur_q)``.  Select rows come out shard-major (each shard's rows after
    the shards before it), not gid-ascending."""
    dwin = cfg.cap_delta if dwin is None else min(dwin, cfg.cap_delta)
    key = (cfg, plans, caps, len(plans), mesh, backend, dwin, xwin, vwin,
           "spmd")
    fn = _cache_get(key)
    if fn is not None:
        return fn

    Q = len(plans)
    F, E, B, K = caps.frontier, caps.expand, caps.bucket, caps.results
    S = cfg.n_shards
    chains, row2q_np, n_br_np, rows_of_q_np = _unit_tables(plans)
    R = len(chains)
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
        """The static tables on one device."""
        def dev_t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def dev_preds(groups):
            return [(pred, dev_t(mask)) for pred, mask in groups]
        return dict(
            row2q=dev_t(row2q_np, torch.int64),
            n_br=dev_t(n_br_np, torch.int32),
            rows_of_q=dev_t(rows_of_q_np, torch.int64),
            start_vt=dev_t([c.start_vtype for c in chains], torch.int32),
            waves=[dict(act=dev_t(w.act), is_out=dev_t(w.is_out),
                        etype=dev_t(w.etype, torch.int32),
                        any_out=w.any_out, any_in=w.any_in,
                        tvt=dev_t(pend_tvt[i], torch.int32),
                        preds=dev_preds(pend_preds[i]))
                   for i, w in enumerate(waves_np)],
            fin_tvt=dev_t(fin_tvt, torch.int32),
            fin_preds=dev_preds(fin_preds),
            final_preds=dev_preds(_final_pred_groups(plans)),
            no_tvt=torch.full((Q,), -1, dtype=torch.int32, device=device),
            nmask=dev_t(kvec_np > 0), kvec=dev_t(kvec_np, torch.int32),
            colk=torch.arange(KMAX, dtype=torch.int32,
                              device=device)[None, :])
    tabs = {d: tables(d) for d in set(mesh.devices)}

    def run(store, keys, vecs, valid_in, ts_q, cur_q):
        sts = mesh_mod.shard_store(store, cfg, mesh)
        T = [tabs[d] for d in mesh.devices]
        keys_l, valid_l = mesh.replicate(keys), mesh.replicate(valid_in)
        ts_l, cur_l = mesh.replicate(ts_q), mesh.replicate(cur_q)
        ts_r = [ts[t["row2q"]] for ts, t in zip(ts_l, T)]  # (R,) per unit
        failed_r = [torch.zeros((R,), dtype=torch.bool, device=k.device)
                    for k in keys_l]
        # ---- lookup wave: every shard probes its own index block ----------
        scan = []
        for me, (st, t) in enumerate(zip(sts, T)):
            look_ok = (valid_l[me] & ~t["nmask"] if has_nearest
                       else valid_l[me])
            g0 = _lookup_local(st, cfg, me, t["start_vt"], keys_l[me],
                               look_ok, ts_r[me], backend, xd_win=xwin)
            scan.append(torch.where(g0 >= 0, g0, PAD))
        g, valid = [], []
        if has_nearest:
            # distributed k-NN probe: each shard scores its own block, the
            # per-shard top-KMAX lists are gathered and merged into one
            # global selection (the same on every shard), and each shard
            # keeps the seeds it owns
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
                cand = torch.cat([scan[me][:, None],
                                  torch.where(seeds_ok, gsel, PAD)], dim=1)
                gm, vm, ovf = _dedup_rows(cand, cand != PAD, F, backend)
                failed_r[me] = failed_r[me] | ovf
                g.append(gm)
                valid.append(vm)
        else:
            for sc in scan:
                gm = torch.full((R, F), PAD, dtype=torch.int32,
                                device=sc.device)
                gm[:, 0] = sc
                g.append(gm)
                valid.append(gm != PAD)

        for w in range(len(waves_np)):
            # 1) batched RPCs: ship the active pairs to their owners
            arr, am, ovf = _route_rows(
                g, [v & t["waves"][w]["act"][:, None]
                    for v, t in zip(valid, T)], S, B)
            for me, (st, t) in enumerate(zip(sts, T)):
                wave = t["waves"][w]
                act = wave["act"]
                ag, amk, ovf2 = _dedup_rows(arr[me], am[me], F, backend)
                failed_r[me] = failed_r[me] | ovf[me] | ovf2
                # 2) owner-side pending checks (the previous hop's)
                alive = amk & _check_rows(st, torch.where(amk, ag // S, 0),
                                          amk, ts_r[me], wave["tvt"],
                                          wave["preds"])
                # 3) worker step: my CSR block + delta log
                parts_g = [g[me]]
                parts_v = [valid[me] & ~act[:, None]]   # parked pairs stay
                row_w = F + (wave["any_out"] + wave["any_in"]) * (E + dwin)
                for direction, dmask, present in (
                        ("out", wave["is_out"], wave["any_out"]),
                        ("in", ~wave["is_out"], wave["any_in"])):
                    if not present:
                        continue
                    m = alive & act[:, None] & dmask[:, None]
                    indptr, nbr, typ, ecre, edel = edges_mod._csr_arrays(
                        st, direction)
                    delta = edges_mod._delta_arrays(st, direction)
                    slot = torch.where(m, ag // S, 0)
                    start = indptr[slot]
                    deg = (indptr[slot + 1] - indptr[slot]) * m
                    failed_r[me] = failed_r[me] | (
                        deg.sum(1, dtype=torch.int32) > E)
                    out_n = _expand_rows(start, deg, (nbr, typ, ecre, edel),
                                         wave["etype"], ts_r[me], E, backend)
                    # my delta block is one shard: window [:dwin]
                    dslot, dnbr, dtyp, dcre, ddel = (a[:dwin] for a in delta)
                    dn = _fit_delta(_delta_rows(ag // S, m, dslot, dnbr, dtyp,
                                                dcre, ddel, wave["etype"],
                                                ts_r[me]), row_w, backend)
                    parts_g += [out_n, dn]
                    parts_v += [out_n >= 0, dn >= 0]
                g[me], valid[me], ovf3 = _dedup_rows(
                    torch.cat(parts_g, dim=1), torch.cat(parts_v, dim=1), F,
                    backend)
                failed_r[me] = failed_r[me] | ovf3

        # ---- finalize: route everything, owed checks, merge, aggregate ----
        arr, am, ovf = _route_rows(g, valid, S, B)
        fin = []
        for me, (st, t) in enumerate(zip(sts, T)):
            ag, v, ovf2 = _dedup_rows(arr[me], am[me], F, backend)
            failed_r[me] = failed_r[me] | ovf[me] | ovf2
            v = v & _check_rows(st, torch.where(v, ag // S, 0), v, ts_r[me],
                                t["fin_tvt"], t["fin_preds"])
            # the intersect-merge is shard-local: every branch's copy of a
            # gid lives on the gid's owner
            if has_star:
                g2, v = _merge_rows(ag, v, t["n_br"], t["rows_of_q"], F,
                                    backend)
            else:
                g2 = ag
            rows_l = torch.where(v, g2 // S, 0)
            if t["final_preds"]:
                v = v & _check_rows(st, rows_l, v, ts_l[me], t["no_tvt"],
                                    t["final_preds"])
            v = v & (g2 > cur_l[me][:, None])   # gid-cursor continuations
            failed_q = torch.zeros((Q,), dtype=torch.int32,
                                   device=ag.device).index_add_(
                0, t["row2q"], failed_r[me].to(torch.int32))
            fin.append((g2, v, rows_l, failed_q))
        out = {"failed_q": mesh_mod.psum([x[3] for x in fin])[0] > 0}
        if terminal == "count":
            out["counts"] = mesh_mod.psum(
                [v.sum(1, dtype=torch.int32) for _, v, _, _ in fin])[0]
            return out

        # select: globally consistent row positions (shard-rank offsets)
        all_counts = mesh_mod.all_gather(
            [v.sum(1, dtype=torch.int32) for _, v, _, _ in fin])   # (S, Q)
        acc_gid, acc_trunc, acc_attr = [], [], []
        for me, (st, (g2, v, rows_l, _)) in enumerate(zip(sts, fin)):
            before = (torch.arange(S, device=v.device) < me)[:, None]
            base = (all_counts[me] * before).sum(0, dtype=torch.int32)
            vi = v.to(torch.int32)
            pos = base[:, None] + torch.cumsum(vi, 1, dtype=torch.int32) - vi
            over = v & (pos >= K)
            col = torch.where(v & ~over, pos, K)
            acc_gid.append(_scatter_rows(Q, K, col,
                                         torch.where(v, g2, 0) + 1, 0))
            acc_trunc.append(over.any(dim=1).to(torch.int32))
            use_cur = st.vdata_ts[rows_l] <= ts_l[me][:, None]
            cols = []
            for kind, colid in select:
                if kind == "key":
                    vals = st.vkey[rows_l]
                elif kind == "f32":
                    vals = torch.where(use_cur, st.vdata_f[rows_l, colid],
                                       st.vprev_f[rows_l, colid])
                else:
                    vals = torch.where(use_cur, st.vdata_i[rows_l, colid],
                                       st.vprev_i[rows_l, colid])
                cols.append(_scatter_rows(Q, K, col, vals, 0))
            acc_attr.append(cols)
        rows_gid = mesh_mod.psum(acc_gid)[0] - 1             # 0 -> NULL
        attrs = {}
        for j, (kind, colid) in enumerate(select):
            summed = mesh_mod.psum([a[j] for a in acc_attr])[0]
            if kind == "key":     # empty cells read NULL like the local path
                summed = torch.where(rows_gid >= 0, summed, _NULL)
            attrs[(kind, colid)] = summed
        out.update(rows_gid=rows_gid, attrs=attrs,
                   truncated=mesh_mod.psum(acc_trunc)[0] > 0)
        return out

    _cache_put(key, run)
    return run
