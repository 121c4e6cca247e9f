"""Edge enumeration and compaction (the two-tier edge lists of §3.2).

Port of ``repro/core/edges.py``.  Enumeration merges the compacted CSR
(tier 1) with the append-only delta log (tier 2) at a snapshot timestamp.
On the reference backend every output slot finds its frontier item with a
``searchsorted`` over the cumulative degree; on the kernel backend the
``edge_expand`` kernel gathers whole spans tile by tile and the surviving
lanes are scattered into the same dense layout, so both backends give the
same buffers.  Compaction merges delta into CSR, drops records dead before
``gc_ts`` and rebuilds the per-slot offsets.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core.addressing import NULL, TS_INF, StoreConfig
from repro_torch.core.store import GraphStore, lexsort, visible

ANY_TYPE = -1
TILE = 128          # edge_expand lane width, kept from the TPU kernel so the
                    # tile plans and the overflow clamps come out the same


def _type_ok(typ, etype: int):
    """Edge-type filter: any type when ``etype`` < 0."""
    return torch.ones_like(typ, dtype=torch.bool) if etype < 0 \
        else typ == etype


def _tiled_csr_expand(qids, deg, start, pools, etype, read_ts, cap_out: int):
    """Kernel-backed CSR expansion, scattered back to the reference layout.

    pools = (nbr, typ, create, delete); returns (out_q, out_n) of (cap_out,).
    Surviving lanes land at exactly the position the reference path writes,
    and masked lanes (or lanes past ``cap_out`` on overflow) are dropped.
    """
    F = deg.shape[0]
    cap_tiles = F + (cap_out + TILE - 1) // TILE
    (nbr_t, typ_t, cre_t, del_t), item, tw, _ = backend_mod.expand_tiles(
        start, deg, pools, tile=TILE, cap_tiles=cap_tiles)
    item_c = torch.clamp(item, max=F - 1)
    excl = torch.cumsum(deg, 0, dtype=torch.int32) - deg
    lane = torch.arange(TILE, dtype=torch.int32, device=deg.device)
    shape = (cap_tiles, TILE)
    nbr_t, typ_t = nbr_t.reshape(shape), typ_t.reshape(shape)
    cre_t, del_t = cre_t.reshape(shape), del_t.reshape(shape)
    # invalid lanes carry -1 in every pool: visible(-1, -1, ts) is False
    e_ok = (visible(cre_t, del_t, read_ts) & _type_ok(typ_t, etype)
            & (nbr_t >= 0))
    pos = excl[item_c][:, None] + tw[:, None] * TILE + lane[None, :]
    pos = torch.where(e_ok & (pos < cap_out), pos, cap_out).reshape(-1)
    out_q = torch.full((cap_out + 1,), int(NULL), dtype=torch.int32,
                       device=deg.device)
    out_q[pos] = qids[item_c][:, None].expand(shape).reshape(-1)
    out_n = torch.full_like(out_q, int(NULL))
    out_n[pos] = nbr_t.reshape(-1)
    return out_q[:cap_out], out_n[:cap_out]


# ---------------------------------------------------------------------------
# Ragged CSR expansion
# ---------------------------------------------------------------------------

def _csr_arrays(store: GraphStore, direction: str):
    if direction == "out":
        return (store.oe_indptr, store.oe_dst, store.oe_type,
                store.oe_create, store.oe_delete)
    elif direction == "in":
        return (store.ie_indptr, store.ie_src, store.ie_type,
                store.ie_create, store.ie_delete)
    raise ValueError(direction)


def _delta_arrays(store: GraphStore, direction: str):
    if direction == "out":
        return (store.dl_slot, store.dl_nbr, store.dl_type,
                store.dl_create, store.dl_delete)
    elif direction == "in":
        return (store.il_slot, store.il_nbr, store.il_type,
                store.il_create, store.il_delete)
    raise ValueError(direction)


def expand(store: GraphStore, cfg: StoreConfig, qids, gids, valid, *,
           etype, direction: str, read_ts, cap_out: int,
           backend: backend_mod.Backend = backend_mod.REF):
    """Enumerate edges of ``gids`` (frontier of shape (F,): query ids, vertex
    gids, mask) of type ``etype`` (or ANY_TYPE) in ``direction`` at snapshot
    ``read_ts``.

    Returns (out_qids, out_nbr, out_valid, overflow): the expansion, shape
    (cap_out + F*S*cap_delta,), plus a bool overflow flag (fast-fail)."""
    S, cap_v, cap_e = cfg.n_shards, cfg.cap_v, cfg.cap_e
    indptr, nbr, typ, ecre, edel = _csr_arrays(store, direction)
    dev = gids.device

    safe_g = torch.where(valid, gids, 0)
    shard = safe_g % S
    iprow = shard * (cap_v + 1) + safe_g // S
    start = indptr[iprow] + shard * cap_e             # absolute pool offset
    deg = (indptr[iprow + 1] - indptr[iprow]) * valid

    F = deg.shape[0]
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    total = cum[-1] if F > 0 else torch.zeros((), dtype=torch.int32,
                                                device=dev)
    overflow = total > cap_out

    if backend.is_kernel:
        out_q, out_n = _tiled_csr_expand(qids, deg, start,
                                         (nbr, typ, ecre, edel), etype,
                                         read_ts, cap_out)
    else:
        k = torch.arange(cap_out, dtype=torch.int32, device=dev)
        item = torch.searchsorted(cum, k, right=True, out_int32=True)
        item_c = torch.clamp(item, max=F - 1)
        base = cum[item_c] - deg[item_c]
        in_range = k < total
        epos = torch.where(in_range, start[item_c] + (k - base), 0)
        n_e = nbr[epos]
        e_ok = (in_range & visible(ecre[epos], edel[epos], read_ts)
                & _type_ok(typ[epos], etype) & (n_e >= 0))
        out_q = torch.where(e_ok, qids[item_c], int(NULL))
        out_n = torch.where(e_ok, n_e, int(NULL))

    # ---- tier 2: delta-log merge (recent, not yet compacted edges) --------
    dslot, dnbr, dtyp, dts, ddel = _delta_arrays(store, direction)
    D = dslot.shape[0]
    d_shard = torch.arange(D, dtype=torch.int32, device=dev) // cfg.cap_delta
    d_gid = dslot * S + d_shard                       # gid of the delta's owner
    m = (valid[:, None]
         & (d_gid[None, :] == safe_g[:, None])
         & (visible(dts, ddel, read_ts) & _type_ok(dtyp, etype)
            & (dnbr >= 0))[None, :])
    dq = torch.where(m, qids[:, None], int(NULL)).reshape(-1)
    dn = torch.where(m, dnbr[None, :], int(NULL)).reshape(-1)

    out_qids = torch.cat([out_q, dq])
    out_nbr = torch.cat([out_n, dn])
    return out_qids, out_nbr, out_nbr >= 0, overflow


def degrees(store: GraphStore, cfg: StoreConfig, gids, valid, *, etype,
            direction: str, read_ts):
    """Raw CSR span size of each frontier vertex (capacity planning; not the
    filtered degree)."""
    S, cap_v = cfg.n_shards, cfg.cap_v
    indptr = _csr_arrays(store, direction)[0]
    safe_g = torch.where(valid, gids, 0)
    iprow = (safe_g % S) * (cap_v + 1) + safe_g // S
    return (indptr[iprow + 1] - indptr[iprow]) * valid


# ---------------------------------------------------------------------------
# Compaction (async workflow, §3.3)
# ---------------------------------------------------------------------------

def _compact_one_shard(slot_c, nbr_c, typ_c, cre_c, del_c,      # CSR (cap_e,)
                       slot_d, nbr_d, typ_d, ts_d, del_d,       # delta
                       gc_ts, cap_v: int):
    """Merge one shard's CSR pool with its delta log; returns the new CSR
    arrays (indptr, nbr, typ, create, delete, overflow).

    Entries dead at ``gc_ts`` are dropped; survivors are sorted by (slot,
    etype, nbr) with stable sorts, so ties keep CSR-then-log order."""
    cap_e = nbr_c.shape[0]
    slot_all = torch.cat([slot_c, slot_d])
    nbr_all = torch.cat([nbr_c, nbr_d])
    typ_all = torch.cat([typ_c, typ_d])
    cre_all = torch.cat([cre_c, ts_d])
    del_all = torch.cat([del_c, del_d])

    live = (nbr_all >= 0) & (del_all > gc_ts)
    skey = torch.where(live, slot_all, cap_v)        # dead sorts last
    skey, typ_s, nbr_s, cre_s, del_s = lexsort(
        (skey, typ_all, nbr_all), (skey, typ_all, nbr_all, cre_all, del_all))
    n_live = live.sum(dtype=torch.int32)
    overflow = n_live > cap_e

    keep = torch.arange(cap_e, dtype=torch.int32, device=nbr_c.device) < n_live
    null, inf = int(NULL), int(TS_INF)
    new_nbr = torch.where(keep, nbr_s[:cap_e], null)
    new_typ = torch.where(keep, typ_s[:cap_e], null)
    new_cre = torch.where(keep, cre_s[:cap_e], inf)
    new_del = torch.where(keep, del_s[:cap_e], inf)
    new_slot = torch.where(keep, skey[:cap_e], cap_v)

    counts = torch.zeros((cap_v + 1,), dtype=torch.int32,
                         device=nbr_c.device).index_add_(
        0, torch.clamp(new_slot, max=cap_v), keep.to(torch.int32))[:cap_v]
    indptr = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=nbr_c.device),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    return indptr, new_nbr, new_typ, new_cre, new_del, overflow


def _slot_of_pool(indptr, cap_e: int):
    """Recover per-entry slot from an indptr (entries below indptr[-1])."""
    k = torch.arange(cap_e, dtype=torch.int32, device=indptr.device)
    return torch.searchsorted(indptr[1:].contiguous(), k, right=True,
                              out_int32=True)


def compact(store: GraphStore, cfg: StoreConfig, gc_ts) -> GraphStore:
    """Compact both edge CSRs (all shards) and empty the delta logs."""
    S, cap_v, cap_e, cap_d = cfg.n_shards, cfg.cap_v, cfg.cap_e, cfg.cap_delta

    def per_direction(indptr, nbr, typ, cre, dele, dslot, dnbr, dtyp, dts,
                      ddel):
        ip = indptr.reshape(S, cap_v + 1)
        shards = [_compact_one_shard(
            _slot_of_pool(ip[s], cap_e), *(a.reshape(S, cap_e)[s]
                                          for a in (nbr, typ, cre, dele)),
            *(a.reshape(S, cap_d)[s] for a in (dslot, dnbr, dtyp, dts, ddel)),
            gc_ts=gc_ts, cap_v=cap_v) for s in range(S)]
        return [torch.cat([sh[i] for sh in shards]) for i in range(5)]

    o_ip, o_nbr, o_typ, o_cre, o_del = per_direction(
        store.oe_indptr, store.oe_dst, store.oe_type, store.oe_create,
        store.oe_delete, *_delta_arrays(store, "out"))
    i_ip, i_nbr, i_typ, i_cre, i_del = per_direction(
        store.ie_indptr, store.ie_src, store.ie_type, store.ie_create,
        store.ie_delete, *_delta_arrays(store, "in"))

    empty = {}
    for p in ("dl", "il"):
        for n, fill in (("slot", NULL), ("nbr", NULL), ("type", NULL),
                        ("create", TS_INF), ("delete", TS_INF), ("count", 0)):
            empty[f"{p}_{n}"] = torch.full_like(getattr(store, f"{p}_{n}"),
                                                int(fill))
    return dataclasses.replace(
        store,
        oe_indptr=o_ip, oe_dst=o_nbr, oe_type=o_typ,
        oe_create=o_cre, oe_delete=o_del,
        ie_indptr=i_ip, ie_src=i_nbr, ie_type=i_typ,
        ie_create=i_cre, ie_delete=i_del, **empty)
