"""Batched k-NN distance and top-k: the CUDA kernel ``csrc/knn_topk.cu`` and
its plain PyTorch version.

Port of ``repro/kernels/knn_topk/kernel.py::knn_topk``.  The plain version
is :func:`repro_torch.kernels.knn_topk.ref.knn_topk`; the kernel sums in the
same order, so the two agree bit for bit.  :func:`knn_topk` runs the plain
version for CPU tensors and launches the kernel for CUDA tensors.

:func:`plan` cuts the work the way the kernel runs it (shapes only, so the
CPU tests reach it): a block of 8 warps spreads ``wr`` of them over query
rows (8 rows a warp, or 1 for the shared-memory lists of k > 32) and the
rest over entries; the index goes in ``n_chunks`` contiguous chunks of
``chunk`` entries (whole tiles of ``te``), about ``target_blocks`` blocks in
all (one wave); the per-chunk lists (``n_lists`` a row) are merged by one block a row
(k <= 32) or in passes of ``group`` lists (k > 32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.knn_topk.ref import knn_topk as knn_topk_plain

WARPS = 8                   # warps a chunk block (kThreads / 32)
STAGES = 2                  # the entry tiles' cp.async ring (kStages)
WARP_K = 32                 # k up to which a row's list lives in a warp
SMEM_MAX = 232_448          # dynamic shared memory a block may use
SMS, SMEM_SM = 132, 233_472  # an H100's SMs and shared memory an SM
MAX_BLOCKS_SM = 2           # __launch_bounds__ of the chunk kernels
MERGE_PAIRS = 16_384        # (dist, gid) pairs a merge block sorts (k > 32)
MAX_K = MERGE_PAIRS // 2    # a merge must take at least two lists


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def shape_of(k: int, wr: int) -> dict:
    """The kernel's layout for ``wr`` warps over rows: the lists' route
    ("warp": warp-held lists, k <= WARP_K; "shared": shared-memory lists),
    rows a warp (rw), entries a lane a tile (et), entries a tile (te), rows
    a block, lists a row a chunk (one a warp over entries, or one)."""
    warp_list = k <= WARP_K
    we = WARPS // wr
    rw = 8 if warp_list else 1
    et = 4 // we if warp_list and we <= 4 else 1
    return dict(route="warp" if warp_list else "shared", rw=rw, et=et,
                te=32 * et * we, rows=wr * rw, lists=we if warp_list else 1)


def target_blocks(smem: int) -> int:
    """Chunk blocks for one wave: as many as an H100 holds at once (the
    shared memory each takes, 1 KB of it reserved), at most two an SM."""
    return SMS * min(MAX_BLOCKS_SM, SMEM_SM // (smem + 1024))


def chunk_smem(D: int, k: int, wr: int) -> int:
    """Shared memory of one chunk block (``chunk_smem`` in the source): the
    block's query rows, the ring's entry rows (DS floats each) and int
    columns, the shared lists of m slots (k > 32) and the rows' (type,
    ts)."""
    sh = shape_of(k, wr)
    D4 = -(-D // 4) * 4
    DS = 4 * ((D4 // 4) | 1)
    ring = STAGES * sh["te"] * (4 * DS + 16)
    m = _pow2ceil(_pow2ceil(k) + sh["te"])
    lists = 0 if sh["route"] == "warp" else sh["rows"] * (8 * m + 12)
    return 4 * sh["rows"] * D4 + ring + lists + 8 * sh["rows"]


def plan(R: int, N: int, D: int, k: int) -> dict:
    """How the kernel cuts an (R rows, N entries, D dims, top-k) call."""
    if k < 1 or k > MAX_K:
        raise ValueError(f"knn_topk: k={k} outside [1, {MAX_K}]")
    kp = _pow2ceil(k)
    if k <= WARP_K:        # few rows: warps over entries; many: over rows
        wr0 = min(WARPS, _pow2ceil(-(-max(1, R) // 8)))
        order = [w for w in (1, 2, 4, 8) if w >= wr0]
    else:                  # one row a warp; more rows, smaller tiles
        wr0 = min(WARPS, _pow2ceil(max(1, R)))
        order = [w for w in (8, 4, 2, 1) if w <= wr0] + \
            [w for w in (1, 2, 4, 8) if w > wr0]
    wr = next((w for w in order if chunk_smem(D, k, w) <= SMEM_MAX), None)
    if wr is None:
        raise ValueError(f"knn_topk: D={D}, k={k} need "
                         f"{chunk_smem(D, k, order[-1])} bytes of shared "
                         f"memory, more than {SMEM_MAX}")
    sh = shape_of(k, wr)
    te = sh["te"]
    row_tiles = -(-max(1, R) // sh["rows"])
    n_tiles = -(-N // te)
    smem = chunk_smem(D, k, wr)
    n_chunks = min(n_tiles, -(-target_blocks(smem) // row_tiles))
    chunk = te * -(-n_tiles // n_chunks) if n_chunks else te
    n_chunks = -(-N // chunk)
    n_lists = n_chunks * sh["lists"]
    return dict(sh, kp=kp, wr=wr, chunk=chunk, n_chunks=n_chunks,
                n_lists=n_lists, group=max(2, MERGE_PAIRS // kp), smem=smem)


def _check(vecs, emb, ints):
    if vecs.dtype != torch.float32 or emb.dtype != torch.float32:
        raise ValueError("knn_topk: vecs and emb must be float32")
    if vecs.dim() != 2 or emb.dim() != 2 or vecs.shape[1] != emb.shape[1]:
        raise ValueError(f"knn_topk: vecs {tuple(vecs.shape)} and emb "
                         f"{tuple(emb.shape)} must be (R, D) and (N, D)")
    N, R = emb.shape[0], vecs.shape[0]
    for name, t, n in zip(("gid", "vtype", "create", "delete", "q_vt",
                           "q_ts"), ints, (N, N, N, N, R, R)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"knn_topk: {name} must be ({n},) int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (vecs, emb, *ints):
        if not t.is_contiguous():
            raise ValueError("knn_topk: inputs must be contiguous")


def knn_topk(vecs, emb, gid, vtype, create, delete, q_vt, q_ts, k: int):
    """Top-k nearest visible entries per query row; see the plain version.
    Returns ``(dist (R, k) f32, gids (R, k) i32)``."""
    ints = (gid, vtype, create, delete, q_vt, q_ts)
    _check(vecs, emb, ints)
    if vecs.device.type == "cpu":
        return knn_topk_plain(vecs, emb, *ints, k)
    _cuda.require_cuda(vecs, emb, *ints)
    R, D = vecs.shape
    N = emb.shape[0]
    pl = plan(R, N, D, k)
    dev = vecs.device
    out_d = torch.empty((R, k), dtype=torch.float32, device=dev)
    out_g = torch.empty((R, k), dtype=torch.int32, device=dev)
    if R == 0:
        return out_d, out_g
    n0 = R * pl["n_lists"] * pl["kp"]
    n1 = 0 if pl["route"] != "shared" else \
        R * -(-pl["n_chunks"] // pl["group"]) * pl["kp"]
    ws = torch.empty((2 * (n0 + n1) + 2,), dtype=torch.int32, device=dev)
    ws_d0, ws_g0 = ws[:n0].view(torch.float32), ws[n0:2 * n0]
    ws_d1 = ws[2 * n0:2 * n0 + n1 + 1].view(torch.float32)
    ws_g1 = ws[2 * n0 + n1 + 1:]
    fn = _cuda.function("knn_topk", "knn_topk", _ARGS)
    rc = fn(*(t.data_ptr() for t in (vecs, emb, *ints, out_d, out_g, ws_d0,
                                     ws_g0, ws_d1, ws_g1)),
            R, N, D, k, pl["kp"], pl["wr"], pl["chunk"], pl["n_chunks"],
            pl["group"], pl["smem"], _cuda.stream_of(vecs))
    _cuda.check(rc, "knn_topk")
    _cuda.LAUNCHES["knn_topk"] += 1
    return out_d, out_g


_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_longlong] + \
    [ctypes.c_int] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p]
