"""Primary index: the BTree of §3.1-3.2, as per-shard sorted arrays.

Port of ``repro/core/index.py``.  Entries are sorted per shard by a 32-bit
mix ``h(vtype, key)`` (empty slots hold INT32_MAX and sort last); a probe is
a windowed binary search (the ``sorted_lookup`` kernel on the kernel
backend) followed by a short scan of the equal-hash run, plus a scan of the
small index delta.  Entries carry MVCC intervals, so probes are snapshot
reads; the newest visible entry wins.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core.addressing import NULL, TS_INF, StoreConfig
from repro_torch.core.store import (GraphStore, lexsort, visible,
                                    window_shard_major)

_C1 = -1640531527             # 2654435769 as int32: Knuth multiplicative
_C2 = -2048144789             # murmur3 c1-ish odd constant
_WINDOW = 16                  # max same-hash run scanned on probe
I32MAX = 2**31 - 1


def mix32(vtype, key):
    """Deterministic 32-bit mix of (vtype, key) on int32 tensors; relies on
    int32 multiplication wrapping around, as the JAX version does."""
    h = key * _C1
    h = h ^ (vtype * _C2)
    return h ^ ((h >> 15) & 0x1FFFF)


def route(vtype, key, n_shards: int):
    """Index shard for a (vtype, key) pair."""
    h = mix32(vtype, key)
    return (h % n_shards + n_shards) % n_shards


def mix32_host(vtype: int, key: int) -> int:
    """Pure-python mirror of :func:`mix32`."""
    M = 0xFFFFFFFF
    h = ((key & M) * 2654435769) & M
    h ^= ((vtype & M) * 2246822507) & M
    h ^= (h >> 15) & 0x1FFFF
    return h - 2**32 if h >= 2**31 else h


def route_host(vtype: int, key: int, n_shards: int) -> int:
    return mix32_host(vtype, key) % n_shards


def lookup(store: GraphStore, cfg: StoreConfig, vtypes, keys, valid, read_ts,
           backend: backend_mod.Backend = backend_mod.REF,
           xd_win: int = None):
    """Batched primary-index probe at a snapshot.

    Returns (gids, found): gid of the live vertex for each (vtype, key), or
    NULL.  ``read_ts`` is a scalar or a ``(Q,)`` tensor of per-query
    snapshots; ``xd_win`` is the per-shard window on the index-delta scan
    (``None`` scans the whole ``cap_idx_delta``, with identical results)."""
    S, cap_x, cap_xd = cfg.n_shards, cfg.cap_idx, cfg.cap_idx_delta
    q = vtypes.shape[0]
    dev = vtypes.device
    h = mix32(vtypes, keys)
    shard = route(vtypes, keys, S)
    base = shard * cap_x

    ix_h = torch.where(store.ix_gid >= 0, mix32(store.ix_vtype, store.ix_key),
                       I32MAX)
    pos0 = backend_mod.searchsorted_blocked(ix_h, h, base, block=cap_x,
                                            backend=backend)
    best_g = torch.full((q,), int(NULL), dtype=torch.int32, device=dev)
    best_ts = torch.full((q,), -1, dtype=torch.int32, device=dev)
    for w in range(_WINDOW):
        row = base + torch.clamp(pos0 + w, max=cap_x - 1)
        g_r, c_r = store.ix_gid[row], store.ix_create[row]
        hit = ((g_r >= 0)
               & (store.ix_vtype[row] == vtypes)
               & (store.ix_key[row] == keys)
               & visible(c_r, store.ix_delete[row], read_ts))
        newer = hit & (c_r > best_ts)
        best_g = torch.where(newer, g_r, best_g)
        best_ts = torch.where(newer, c_r, best_ts)
    g_main = torch.where(valid, best_g, int(NULL))
    ts_main = torch.where(valid, best_ts, -1)

    # delta scan (small): (Q, S*W) match matrix, newest visible entry wins
    W = cap_xd if xd_win is None else min(int(xd_win), cap_xd)
    xd_vt, xd_k, xd_g, xd_c, xd_d = window_shard_major(
        (store.xd_vtype, store.xd_key, store.xd_gid,
         store.xd_create, store.xd_delete), S, cap_xd, W)
    xd_shard = torch.arange(S * W, dtype=torch.int32, device=dev) // W
    rts = read_ts
    if isinstance(rts, torch.Tensor) and rts.dim() == 1:
        rts = rts[:, None]
    m = (valid[:, None]
         & (xd_vt[None, :] == vtypes[:, None])
         & (xd_k[None, :] == keys[:, None])
         & (xd_shard[None, :] == shard[:, None])
         & (xd_g >= 0)[None, :]
         & visible(xd_c[None, :], xd_d[None, :], rts))
    ts_d = torch.where(m, xd_c[None, :], -1)
    best_d = torch.argmax(ts_d, dim=1)        # first maximum, as jnp.argmax
    ts_delta = ts_d.amax(dim=1)
    g_delta = torch.where(ts_delta >= 0, xd_g[best_d], int(NULL))

    gids = torch.where(ts_delta > ts_main, g_delta, g_main)
    return gids, gids >= 0


def compact_index(store: GraphStore, cfg: StoreConfig, gc_ts) -> GraphStore:
    """Merge the index delta into the sorted main index (all shards)."""
    S, cap_x, cap_xd = cfg.n_shards, cfg.cap_idx, cfg.cap_idx_delta
    names = ("vtype", "key", "gid", "create", "delete")
    main = [getattr(store, f"ix_{n}").reshape(S, cap_x) for n in names]
    delta = [getattr(store, f"xd_{n}").reshape(S, cap_xd) for n in names]
    shards = [merge_index_entries(
        *[torch.cat([m[s], x[s]]) for m, x in zip(main, delta)],
        gc_ts=gc_ts, cap_x=cap_x) for s in range(S)]
    cols = [torch.cat([sh[i] for sh in shards]) for i in range(5)]
    counts = torch.stack([sh[5] for sh in shards]).to(torch.int32)
    empty = {f"xd_{n}": torch.full_like(getattr(store, f"xd_{n}"), fill)
             for n, fill in zip(names, (int(TS_INF), int(TS_INF), int(NULL),
                                        int(TS_INF), int(TS_INF)))}
    return dataclasses.replace(
        store, **{f"ix_{n}": c for n, c in zip(names, cols)},
        ix_count=counts, xd_count=torch.zeros_like(store.xd_count), **empty)


def merge_index_entries(vt, k, g, c, d, *, gc_ts, cap_x: int):
    """One shard's merge of at least ``cap_x`` index entries: drop entries
    dead at ``gc_ts``, sort the survivors by (mix32, vtype, key), keep the
    first ``cap_x``.  Returns (vtype, key, gid, create, delete, live count).
    """
    live = (g >= 0) & (d > gc_ts)
    h = torch.where(live, mix32(vt, k), I32MAX)
    vt_s, k_s, g_s, c_s, d_s = lexsort((h, vt, k), (vt, k, g, c, d))
    n_live = live.sum(dtype=torch.int32)
    keep = torch.arange(cap_x, dtype=torch.int32, device=vt.device) < n_live
    inf, null = int(TS_INF), int(NULL)
    return (torch.where(keep, vt_s[:cap_x], inf),
            torch.where(keep, k_s[:cap_x], inf),
            torch.where(keep, g_s[:cap_x], null),
            torch.where(keep, c_s[:cap_x], inf),
            torch.where(keep, d_s[:cap_x], inf), n_live)
