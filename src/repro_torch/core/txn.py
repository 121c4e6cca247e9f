"""Transaction engine: FaRMv2-style MVCC + optimistic concurrency (§2.1, §5.2).

Port of ``repro/core/txn.py``.  A global clock hands out commit timestamps;
read-only queries run at a snapshot ``read_ts`` and never conflict; update
transactions record a read set and are validated at commit, aborting if an
object they read was written after their snapshot.  Transactions are
gathered into commit batches: a batch gets one timestamp per chunk,
validation is one vectorised gather and intra-batch conflicts resolve
first-wins (``core/writes.py``).

The JAX package jits :func:`apply_batch_impl` and donates the store; here it
is an eager function that updates the store's tensors in place, which leaves
the same state.  Op arrays are padded with -1 rows (pow2 buckets, as the
JAX package pads them); every scatter filters the padded rows out with a
mask first, every gather clamps its index, and where two rows of one
scatter land on the same place with different values (one gid updated twice
in a transaction) the last one is kept, as XLA on the CPU keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import index as ix
from repro_torch.core.addressing import TS_INF, StoreConfig
from repro_torch.core.store import GraphStore


@dataclasses.dataclass(frozen=True)
class BatchCaps:
    """Op capacities of one commit chunk."""
    reads: int = 256
    create_v: int = 256
    update_v: int = 128
    delete_v: int = 64
    create_e: int = 512
    delete_e: int = 256


class Aborted(Exception):
    """Raised to the caller when a transaction loses OCC validation."""


class Transaction:
    """Client-side transaction: buffered reads + staged writes (Fig. 2 API).

    All mutations are staged host-side and pushed at commit, as FaRM
    buffers writes locally."""

    __slots__ = ("read_ts", "reads", "create_v", "update_v", "delete_v",
                 "create_e", "delete_e", "status", "rid")

    def __init__(self, read_ts: int):
        self.read_ts = int(read_ts)
        self.reads: list[tuple[int, str]] = []      # (gid, kind)
        self.create_v: list[tuple] = []             # (gid, vtype, key, f, i)
        self.update_v: list[tuple] = []             # (gid, f, i)
        self.delete_v: list = []                    # (gid, vtype, key)
        self.create_e: list[tuple] = []             # (src, dst, etype)
        self.delete_e: list[tuple] = []             # (src, dst, etype)
        self.status = "OPEN"
        self.rid: Optional[str] = None              # client request id

    def record_read(self, gid: int) -> None:
        if gid is not None and gid >= 0:
            self.reads.append((int(gid), "v"))

    # key sets for intra-batch conflict detection: vertex object ("v", gid)
    # and edge-list object ("ev", gid); an edge write touches both
    # endpoints' edge-list objects (FaRM object model)
    def write_keys(self):
        ks = set()
        for g, *_ in self.create_v:
            ks.add(("v", g))
        for g, *_ in self.update_v:
            ks.add(("v", g))
        for g, *_ in self.delete_v:
            ks.add(("v", g))
            ks.add(("ev", g))
        for s, d, t in self.create_e:
            ks.add(("ev", s))
            ks.add(("ev", d))
        for s, d, t in self.delete_e:
            ks.add(("ev", s))
            ks.add(("ev", d))
        return ks

    def read_keys(self):
        return {("ev" if kind == "e" else "v", g) for g, kind in self.reads}


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def last_write_ts(store: GraphStore, cfg: StoreConfig, gids, kinds):
    """Latest write ts of each read object (0 if never written).

    ``kinds``: 0 = vertex header/data read, 1 = edge-list read; the vertex
    object and its edge-list object are versioned separately."""
    ok = gids >= 0
    rows = cfg.row_of_gid(torch.where(ok, gids, 0))
    inf = int(TS_INF)
    cre = store.v_create[rows]
    dele = store.v_delete[rows]
    cre = torch.where(cre == inf, 0, cre)
    dele = torch.where(dele == inf, 0, dele)
    lw = torch.maximum(cre, dele)
    lw_v = torch.maximum(lw, store.vdata_ts[rows])
    lw_e = torch.maximum(lw, store.v_edgever[rows])
    return torch.where(ok, torch.where(kinds == 1, lw_e, lw_v), 0)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _csr_find(indptr2, typ2d, nbr2d, sh, slot, etype, dst):
    """Binary search of CSR spans (sorted by (etype, nbr)) for one edge per
    op, all ops at once: ``indptr2`` is (S, cap_v + 1), ``typ2d`` and
    ``nbr2d`` (S, cap_e).  Returns the shard-local pool position (< cap_e)
    or -1, after 32 halving steps, as the JAX package's loop.  Probe
    positions are clamped to the pool: a shard's last span may end at
    cap_e, where the JAX gather clamps too."""
    cap_e = typ2d.shape[1]
    lo = indptr2[sh, slot]
    end = indptr2[sh, slot + 1]
    hi = end
    for _ in range(32):
        m = (lo + hi) // 2
        mc = torch.clamp(m, max=cap_e - 1)
        tm, dm = typ2d[sh, mc], nbr2d[sh, mc]
        go_right = ((tm < etype) | ((tm == etype) & (dm < dst))) & (lo < hi)
        lo, hi = torch.where(go_right, m + 1, lo), torch.where(go_right, hi, m)
    lc = torch.clamp(lo, max=cap_e - 1)
    found = (lo < end) & (typ2d[sh, lc] == etype) & (nbr2d[sh, lc] == dst)
    return torch.where(found, lo, -1)


def _put(arr, idx, ok, val):
    """``arr[idx[ok]] = val[ok]``, ``val`` a tensor with one row an index or
    a scalar.  Rows with equal indices must carry equal values (see
    :func:`_last_wins`), so the result does not depend on their order."""
    if isinstance(val, torch.Tensor) and val.dim() > 0:
        arr[idx[ok].long()] = val[ok].to(arr.dtype)
    else:
        arr[idx[ok].long()] = int(val)


def _last_wins(idx, ok):
    """``ok`` less every row whose index a later ``ok`` row repeats: the
    row XLA's scatter on the CPU leaves in place (a chunk's ops are few, so
    an all-pairs compare)."""
    n = idx.shape[0]
    r = torch.arange(n, device=idx.device)
    later = ((idx[None, :] == idx[:, None]) & ok[None, :]
             & (r[None, :] > r[:, None]))
    return ok & ~later.any(dim=1)


def apply_batch_impl(store: GraphStore, cfg: StoreConfig, ts: int,
                     # create vertices
                     cv_gid, cv_vtype, cv_key, cv_f, cv_i, cv_xpos,
                     # update vertices
                     uv_gid, uv_f, uv_i,
                     # delete vertices
                     dv_gid, dv_vtype, dv_key,
                     # create edges
                     ce_src, ce_dst, ce_type, ce_opos, ce_ipos,
                     # delete edges
                     de_src, de_dst, de_type,
                     # new per-shard log counts (host-computed)
                     new_dl_count, new_il_count, new_xd_count) -> GraphStore:
    """Apply one validated commit chunk at timestamp ``ts``, in place.

    Vertex and edge-pool addresses stay two-dimensional (shard, local) as
    in the JAX package, flattened only for the scatter.  Rows with a
    negative gid or position are padding."""
    S, cap_v, cap_e = cfg.n_shards, cfg.cap_v, cfg.cap_e
    ts = int(ts)
    inf = int(TS_INF)

    def vrow(gid):
        ok = gid >= 0
        g = torch.where(ok, gid, 0)
        return (g % S) * cap_v + g // S, ok

    # ---- create vertices -------------------------------------------------
    row, ok = vrow(cv_gid)
    _put(store.vtype, row, ok, cv_vtype)
    _put(store.vkey, row, ok, cv_key)
    _put(store.v_create, row, ok, ts)
    _put(store.v_delete, row, ok, inf)
    for name, val in (("vdata_f", cv_f), ("vdata_i", cv_i),
                      ("vdata_ts", ts), ("vprev_f", cv_f), ("vprev_i", cv_i),
                      ("vprev_ts", ts)):
        _put(getattr(store, name), row, ok, val)
    # index-delta entries (flat positions host-assigned)
    xok = cv_xpos >= 0
    _put(store.xd_vtype, cv_xpos, xok, cv_vtype)
    _put(store.xd_key, cv_xpos, xok, cv_key)
    _put(store.xd_gid, cv_xpos, xok, cv_gid)
    _put(store.xd_create, cv_xpos, xok, ts)
    _put(store.xd_delete, cv_xpos, xok, inf)

    # ---- update vertex data (cur -> prev, new -> cur) --------------------
    row, ok = vrow(uv_gid)
    cur_f, cur_i = store.vdata_f[row], store.vdata_i[row]
    cur_ts = store.vdata_ts[row]
    _put(store.vprev_f, row, ok, cur_f)
    _put(store.vprev_i, row, ok, cur_i)
    _put(store.vprev_ts, row, ok, cur_ts)
    # one gid updated twice in a transaction: its last row wins
    last = _last_wins(row, ok)
    _put(store.vdata_f, row, last, uv_f)
    _put(store.vdata_i, row, last, uv_i)
    _put(store.vdata_ts, row, ok, ts)

    # ---- delete vertices -------------------------------------------------
    row, ok = vrow(dv_gid)
    if dv_gid.shape[0]:
        xpos = _find_ix_rows(store, cfg, dv_gid, dv_vtype, dv_key)
        xrow = _find_xd_rows(store, cfg, dv_gid, dv_vtype, dv_key)
        _put(store.v_delete, row, ok, ts)
        _put(store.ix_delete, xpos, xpos >= 0, ts)
        _put(store.xd_delete, xrow, xrow >= 0, ts)

    # ---- create edges (append to both half-edge delta logs) --------------
    src_slot = torch.where(ce_src >= 0, torch.div(ce_src, S,
                                                  rounding_mode="floor"), -1)
    dst_slot = torch.where(ce_dst >= 0, torch.div(ce_dst, S,
                                                  rounding_mode="floor"), -1)
    for g in (ce_src, ce_dst, de_src, de_dst):
        r, o = vrow(g)
        _put(store.v_edgever, r, o, ts)
    ook, iok = ce_opos >= 0, ce_ipos >= 0
    for p, pos, okp, slot, nbr in (("dl", ce_opos, ook, src_slot, ce_dst),
                                   ("il", ce_ipos, iok, dst_slot, ce_src)):
        _put(getattr(store, f"{p}_slot"), pos, okp, slot)
        _put(getattr(store, f"{p}_nbr"), pos, okp, nbr)
        _put(getattr(store, f"{p}_type"), pos, okp, ce_type)
        _put(getattr(store, f"{p}_create"), pos, okp, ts)
        _put(getattr(store, f"{p}_delete"), pos, okp, inf)
    store.dl_count.copy_(new_dl_count)
    store.il_count.copy_(new_il_count)
    store.xd_count.copy_(new_xd_count)

    # ---- delete edges (CSR binary search + delta tombstones) -------------
    if de_src.shape[0]:
        for (own, other, indptr, typ, nbr, dele, logp) in (
                (de_src, de_dst, store.oe_indptr, store.oe_type,
                 store.oe_dst, store.oe_delete, "dl"),
                (de_dst, de_src, store.ie_indptr, store.ie_type,
                 store.ie_src, store.ie_delete, "il")):
            okd = own >= 0
            g = torch.where(okd, own, 0)
            fsh, fsl = g % S, g // S
            pos = _csr_find(indptr.view(S, cap_v + 1), typ.view(S, cap_e),
                            nbr.view(S, cap_e), fsh, fsl, de_type, other)
            found = okd & (pos >= 0)
            _put(dele, fsh * cap_e + pos, found, ts)
        # also tombstone matching live delta-log inserts
        m_out = _delta_match(store, cfg, "dl", de_src, de_dst, de_type)
        m_in = _delta_match(store, cfg, "il", de_dst, de_src, de_type)
        store.dl_delete.masked_fill_(m_out, ts)
        store.il_delete.masked_fill_(m_in, ts)
    return store


def _find_ix_rows(store, cfg, g, vt, k):
    """Flat main-index position of each live entry (vt, k, g), or -1: a
    left search of the key's hash in its shard's sorted block, then the
    first hit of a 16-entry scan."""
    S, cap_x = cfg.n_shards, cfg.cap_idx
    inf = int(TS_INF)
    ix_h = torch.where(store.ix_gid >= 0, ix.mix32(store.ix_vtype,
                                                   store.ix_key), ix.I32MAX)
    ish = ix.route(vt, k, S)
    pos = backend_mod.searchsorted_blocked(ix_h, ix.mix32(vt, k), ish * cap_x,
                                           block=cap_x, backend=backend_mod.REF)
    best = torch.full_like(g, -1)
    for w in range(16):
        pp = ish * cap_x + torch.clamp(pos + w, max=cap_x - 1)
        hit = ((store.ix_gid[pp] == g) & (store.ix_vtype[pp] == vt)
               & (store.ix_key[pp] == k) & (store.ix_delete[pp] == inf))
        best = torch.where(hit & (best < 0), pp, best)
    return torch.where(g >= 0, best, -1)


def _find_xd_rows(store, cfg, g, vt, k):
    """Flat index-delta row of each live entry (vt, k, g) in its routed
    shard, the first match, or -1."""
    XD = store.xd_gid.shape[0]
    inf = int(TS_INF)
    ish = ix.route(vt, k, cfg.n_shards)
    r = torch.arange(XD, dtype=torch.int32, device=g.device)
    m = ((store.xd_gid[None, :] == g[:, None])
         & (store.xd_vtype[None, :] == vt[:, None])
         & (store.xd_key[None, :] == k[:, None])
         & (store.xd_delete == inf)[None, :]
         & ((r // cfg.cap_idx_delta)[None, :] == ish[:, None]))
    first = torch.where(m, r[None, :], XD).amin(dim=1)
    return torch.where((g >= 0) & (first < XD), first, -1)


def _delta_match(store, cfg, p, ent_gid, nbr, t):
    """(D,) mask of the live ``p``-log entries matching any (ent_gid, nbr,
    t) edge: the owner's slot and shard, the neighbour and the type."""
    S = cfg.n_shards
    slot = getattr(store, f"{p}_slot")
    ok = ent_gid >= 0
    eg = torch.where(ok, ent_gid, 0)
    d_shard = torch.arange(slot.shape[0], dtype=torch.int32,
                           device=slot.device) // cfg.cap_delta
    m = (ok[:, None] & (slot[None, :] == (eg // S)[:, None])
         & (d_shard[None, :] == (eg % S)[:, None])
         & (getattr(store, f"{p}_nbr")[None, :] == nbr[:, None])
         & (getattr(store, f"{p}_type")[None, :] == t[:, None])
         & (getattr(store, f"{p}_delete") == int(TS_INF))[None, :])
    return m.any(dim=0)


# ---------------------------------------------------------------------------
# padding helpers (host lists -> device tensors)
# ---------------------------------------------------------------------------

def pad_i32(xs, cap, fill=-1, *, device):
    a = np.full((cap,), fill, np.int32)
    n = min(len(xs), cap)
    if n:
        a[:n] = np.asarray(xs[:n], np.int32)
    return torch.as_tensor(a, device=device)


def pad_f32(xs, cap, d, *, device):
    a = np.zeros((cap, d), np.float32)
    n = min(len(xs), cap)
    if n:
        a[:n] = np.asarray(xs[:n], np.float32).reshape(n, d)
    return torch.as_tensor(a, device=device)


def pad_i32_2d(xs, cap, d, *, device):
    a = np.zeros((cap, d), np.int32)
    n = min(len(xs), cap)
    if n:
        a[:n] = np.asarray(xs[:n], np.int32).reshape(n, d)
    return torch.as_tensor(a, device=device)
