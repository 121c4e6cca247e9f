"""PyTorch port, the ``knn_topk`` kernel (``csrc/knn_topk.cu``) as far as
the CPU can check it: the kernel's cut (``plan``) and its top-k lists
emulated in numpy, the 32 lanes of a warp as a vector axis.  The chunk
kernel's warps walk their chunk's tiles (each lane its entries lane + 32 h
of the warp's slice of a tile), flag the entries that beat their row's
threshold at the tile's start and insert them, (row, h) group by group
and lane by lane, into the warp-held lists (a ballot for the place, a
shuffle up, the threshold shuffled again), or, for k > 32, keep a
shared-memory list of kp a row sorted after each tile; then the merge (one block a row: 32 warps over
32-entry windows, four at a time, then warp 0 over the others' lists; or
passes of ``group`` sorted lists).  Distances come from the plain
version's ``distances`` (the kernel's summation order), so the emulation
checks what the CPU cannot run: which entries reach which lists, and the
list logic.  It must equal ``knn_topk_plain`` bit for bit.  The CUDA
kernel runs only on the GPU, where ``chip_smoke.py`` holds it to the same
kinds of cases.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.knn_topk import kernel as kk
from repro_torch.kernels.knn_topk import ref as kref

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

I32MAX = 2**31 - 1
INF = np.float32(np.inf)
LANES = np.arange(32)


def _less(da, ga, db, gb):
    return (da < db) | ((da == db) & (ga < gb))


def _insert(ld, lg, d, g, k):
    """insert(): the lanes' sorted list takes (d, g) if it beats lane k-1."""
    if not _less(d, g, ld[k - 1], lg[k - 1]):
        return
    pos = int(_less(ld, lg, d, g).sum())          # popc(ballot)
    ud, ug = np.roll(ld, 1), np.roll(lg, 1)       # shfl_up by 1
    up = LANES > pos
    ld[up], lg[up] = ud[up], ug[up]
    ld[pos], lg[pos] = d, g


def _offer(ld, lg, flag, d, g, k):
    """offer(): the flagged lanes inserted one by one, in lane order."""
    for lane in np.flatnonzero(flag):
        _insert(ld, lg, d[lane], g[lane], k)


def _inputs(R, N, D, seed):
    rng = np.random.default_rng(seed)
    gid = rng.permutation(4 * N)[:N]
    gid[rng.random(N) < 0.2] = -1
    cr = rng.integers(0, 10, N)
    emb = rng.normal(size=(N, D))
    emb[::7] = emb[:1]                             # ties broken by gid
    return [np.asarray(a, dt) for a, dt in (
        (rng.normal(size=(R, D)), np.float32), (emb, np.float32),
        (gid, np.int32), (rng.integers(0, 2, N), np.int32), (cr, np.int32),
        (np.where(rng.random(N) < 0.3, cr + rng.integers(1, 10, N), I32MAX),
         np.int32), (rng.integers(0, 2, R), np.int32),
        (rng.integers(0, 10, R), np.int32))]


def emulate(vecs, emb, gid, vtype, create, delete, q_vt, q_ts, k):
    R, D = vecs.shape
    N = emb.shape[0]
    pl = kk.plan(R, N, D, k)
    kp, te, et, wr = pl["kp"], pl["te"], pl["et"], pl["wr"]
    dist = kref.distances(torch.as_tensor(vecs), torch.as_tensor(emb)).numpy()
    vis = ((gid >= 0)[None] & (vtype[None] == q_vt[:, None])
           & (create[None] <= q_ts[:, None]) & (q_ts[:, None] < delete[None]))
    lists_d = np.full((R, max(1, pl["n_lists"]), kp), INF, np.float32)
    lists_g = np.full((R, max(1, pl["n_lists"]), kp), I32MAX, np.int64)
    seen = np.zeros((R, N), np.int64)
    for c in range(pl["n_chunks"]):
        lo, hi = c * pl["chunk"], min(N, (c + 1) * pl["chunk"])
        for r0 in range(0, R, pl["rows"]):
            if pl["route"] == "warp":
                for warp in range(kk.WARPS):
                    w_r, w_e = warp % wr, warp // wr
                    for i in range(8):
                        r = r0 + w_r * 8 + i
                        if r >= R:
                            break
                        ld = np.full(32, INF, np.float32)
                        lg = np.full(32, I32MAX, np.int64)
                        for t0 in range(lo, hi, te):
                            thd, thg = ld[k - 1], lg[k - 1]
                            for h in range(et):
                                j = t0 + w_e * 32 * et + LANES + 32 * h
                                ok = j < min(hi, t0 + te)
                                j = np.where(ok, j, 0)
                                seen[r, j[ok]] += 1
                                flag = ok & vis[r, j] & _less(
                                    dist[r, j], gid[j], thd, thg)
                                _offer(ld, lg, flag, dist[r, j], gid[j], k)
                        lst = c * (kk.WARPS // wr) + w_e
                        lists_d[r, lst, :k] = ld[:k]
                        lists_g[r, lst, :k] = lg[:k]
            else:
                for r in range(r0, min(R, r0 + pl["rows"])):
                    bd = np.full(kp, INF, np.float32)
                    bg = np.full(kp, I32MAX, np.int64)
                    for t0 in range(lo, hi, te):
                        j = np.arange(t0, min(hi, t0 + te))
                        seen[r, j] += 1
                        flag = vis[r, j] & _less(dist[r, j], gid[j],
                                                 bd[-1], bg[-1])
                        d = np.concatenate([bd, dist[r, j[flag]]])
                        g = np.concatenate([bg, gid[j[flag]]])
                        o = np.lexsort((g, d))[:kp]
                        bd, bg = d[o], g[o]
                    lists_d[r, c], lists_g[r, c] = bd, bg
    assert (seen == 1).all()               # every entry, once a row
    out_d = np.full((R, k), INF, np.float32)
    out_g = np.full((R, k), I32MAX, np.int64)
    for r in range(R):
        d, g = lists_d[r].ravel(), lists_g[r].ravel()
        if pl["route"] == "warp":          # knn_merge_warp_kernel
            wl = []
            for warp in range(32):
                ld = np.full(32, INF, np.float32)
                lg = np.full(32, I32MAX, np.int64)
                for c0 in range(warp, -(-d.size // 32), 32):
                    wd = np.full(32, INF, np.float32)
                    wg = np.full(32, I32MAX, np.int64)
                    n = min(32, d.size - 32 * c0)
                    wd[:n], wg[:n] = d[32 * c0:32 * c0 + n], \
                        g[32 * c0:32 * c0 + n]
                    _offer(ld, lg, _less(wd, wg, ld[k - 1], lg[k - 1]), wd,
                           wg, k)
                wl.append((ld, lg))
            ld, lg = wl[0]
            for od, og in wl[1:]:
                _offer(ld, lg, (LANES < k) & _less(od, og, ld[k - 1],
                                                   lg[k - 1]), od, og, k)
            out_d[r], out_g[r] = ld[:k], lg[:k]
        else:                              # passes of `group` sorted lists
            o = np.lexsort((g, d))[:k]
            out_d[r, :o.size], out_g[r, :o.size] = d[o], g[o]
    return out_d, out_g, pl


@pytest.mark.parametrize("R,N,D,k,route", [
    (1, 1500, 8, 8, "warp"), (3, 700, 5, 1, "warp"), (12, 900, 4, 32, "warp"),
    (1, 70_000, 4, 8, "warp"),          # two tiles a chunk
    (40, 300, 8, 8, "warp"), (70, 400, 5, 3, "warp"),
    (2, 600, 8, 33, "shared"),
    (9, 257, 4, 40, "shared"), (2, 1, 4, 8, "warp"), (2, 0, 4, 8, "warp")])
def test_emulated_lists_match_plain(R, N, D, k, route):
    """Both list routes over the cuts R gives (warps over entries at R <=
    8, over rows past), N at and off tile edges, D not a multiple of 4,
    k = 1 and 32, duplicate embeddings: bit for bit the plain version."""
    args = _inputs(R, N, D, R * N + k)
    got_d, got_g, pl = emulate(*args, k)
    assert pl["route"] == route
    want_d, want_g = kk.knn_topk_plain(*map(torch.as_tensor, args), k)
    np.testing.assert_array_equal(got_d.view(np.int32),
                                  want_d.numpy().view(np.int32))
    np.testing.assert_array_equal(got_g, want_g.numpy())
