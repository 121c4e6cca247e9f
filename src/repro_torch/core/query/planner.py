"""Multi-query planner: fused operator waves across plan shapes (§3.4, §5).

Port of the local path of ``repro/core/query/planner.py``.  A batch of A1QL
plans — chains and star patterns — sharing a terminal signature and caps
runs as one fused wave program over the R *chain units* (a chain is one
unit, a star one unit per branch):

  * lookup wave — every unit's start probe in one ``index.lookup`` call;
  * hop wave k — every unit with a k-th hop expands its frontier region in
    one tile plan per direction; per-unit edge types and snapshots are
    vectors; finished units are parked and ride along;
  * intersect-merge wave — each star's branch regions fold into one query
    region (a sort plus run lengths keeps gids reached by every branch).

The frontier is an (R, frontier) matrix whose row r holds unit r's
sorted-unique gids, so every query keeps its own §3.4 budget and snapshot
and its results (fast-fail flags included) equal a solo run.  The SPMD
programs, the k-NN probe wave and the shared-frontier budget are later
slices of the port.
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
                                             eval_pred, select_attrs)
from repro_torch.core.store import visible, window_shard_major

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


def compile_batch(cfg: StoreConfig, plans: tuple, caps: QueryCaps,
                  backend: backend_mod.Backend = backend_mod.REF,
                  dwin: Optional[int] = None, xwin: Optional[int] = None,
                  device="cpu"):
    """The fused-wave program for one batch shape:
    ``run(store, keys, valid_in, ts_q, cur_q)``.

    ``plans`` is a tuple of logical plans (chains and/or stars) sharing a
    terminal signature; start keys (one per chain unit, branch-major per
    query), per-query snapshots and gid cursors stay runtime tensors.
    ``dwin``/``xwin`` are the edge / primary-index delta windows."""
    dwin = cfg.cap_delta if dwin is None else min(dwin, cfg.cap_delta)
    device = torch.device(device)
    key = (cfg, plans, caps, len(plans), backend, dwin, xwin, str(device),
           "local")
    fn = _CACHE.get(key)
    if fn is not None:
        _CACHE.move_to_end(key)
        return fn
    for p in plans:
        if any(c.nearest_k > 0 for c in p.chain_units()):
            raise NotImplementedError(
                "Nearest (k-NN probe) plans are a later slice of the port "
                "(ROADMAP queue 1, item 8)")

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

    def run(store, keys, valid_in, ts_q, cur_q):
        ts_r = ts_q[row2q]                                  # (R,) per unit
        failed_r = torch.zeros((R,), dtype=torch.bool, device=device)
        # ---- lookup wave: one probe for every chain unit ------------------
        gids0, found = index_mod.lookup(store, cfg, start_vt, keys, valid_in,
                                        ts_r, backend=backend, xd_win=xwin)
        g = torch.full((R, F), PAD, dtype=torch.int32, device=device)
        g[:, 0] = torch.where(found & valid_in, gids0, PAD)
        valid = g != PAD

        for wave in waves:
            act = wave["act"]
            # parked units carry their finished frontier through the wave
            parts_g, parts_v = [g], [valid & ~act[:, None]]
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
                dn = _delta_rows(g, m, dslot * S + d_shard, dnbr, dtyp, dcre,
                                 ddel, wave["etype"], ts_r)
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

    _CACHE[key] = run
    while len(_CACHE) > CACHE_MAX_PROGRAMS:
        _CACHE.popitem(last=False)
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
        return QueryResult(
            counts=self.counts, rows_gid=self.rows_gid,
            rows=self.rows or None, truncated=self.truncated,
            failed=bool(self.failed_q.any()), failed_q=self.failed_q,
            deadline_q=self.deadline_q)


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


def execute_fused(db, lowered: list, eff_caps: list, ts_list: list[int],
                  be: backend_mod.Backend,
                  cursors: Optional[Sequence[int]] = None,
                  deadline: Optional[float] = None) -> QueryResult:
    """Run pre-lowered plans as fused multi-query waves with per-query
    budgets (``budget="per-query"``): results, with per-query ``failed_q``
    flags, equal running each query alone.  ``cursors`` is the per-query
    gid cursor (-1 = none); ``deadline`` is an absolute
    ``time.monotonic()`` instant past which a group is skipped and flagged
    ``deadline_q``."""
    Q = len(lowered)
    dev = db.device
    out = _Assembly(Q, max(c.results for c in eff_caps))
    dwin = delta_window(db)
    xwin = index_window(db)
    cursors = [-1] * Q if cursors is None else list(cursors)
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
        fn = compile_batch(db.cfg, plans_g, caps_g, be, dwin, xwin, dev)
        valid = torch.ones((keys.shape[0],), dtype=torch.bool, device=dev)
        out.put(idxs, fn(db.store, keys, valid, ts, cur))
    return out.result()
