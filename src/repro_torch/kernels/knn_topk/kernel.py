"""Batched k-NN distance and top-k: the CUDA kernel ``csrc/knn_topk.cu`` and
its plain PyTorch version.

Port of ``repro/kernels/knn_topk/kernel.py::knn_topk``.  The plain version
is :func:`repro_torch.kernels.knn_topk.ref.knn_topk`; the kernel sums in the
same order, so the two agree bit for bit.  :func:`knn_topk` runs the plain
version for CPU tensors and launches the kernel for CUDA tensors.

:func:`plan` cuts the work the way the kernel runs it (shapes only, so the
CPU tests reach it): the index in ``n_chunks`` chunks of ``chunk`` entries,
the query rows in tiles of ``rt``, and the per-chunk top-``kp`` lists merged
``group`` at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.knn_topk.ref import knn_topk as knn_topk_plain

TILE = 64                   # entries a block stages at once (kTile)
MAX_ROWS = 64               # query rows a block holds (8 warps x 8)
SMEM_MAX = 232_448          # dynamic shared memory a block may use
TARGET_CHUNKS = 512         # ~4 blocks per SM per row tile on 132 SMs
MERGE_PAIRS = 16_384        # (dist, gid) pairs a merge block sorts
MAX_K = MERGE_PAIRS // 2    # a merge must take at least two lists


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def chunk_smem(D: int, kp: int, rt: int) -> int:
    """Shared memory of one chunk block (the layout in the source)."""
    m = _pow2ceil(kp + TILE)
    return 4 * (rt * D + TILE * (D | 1) + 5 * TILE + 5 * rt) + 8 * rt * m


def plan(R: int, N: int, D: int, k: int) -> dict:
    """How the kernel cuts an (R rows, N entries, D dims, top-k) call."""
    if k < 1 or k > MAX_K:
        raise ValueError(f"knn_topk: k={k} outside [1, {MAX_K}]")
    kp = _pow2ceil(k)
    rt = min(MAX_ROWS, _pow2ceil(max(1, R)))
    while rt > 1 and chunk_smem(D, kp, rt) > SMEM_MAX:
        rt //= 2
    smem = chunk_smem(D, kp, rt)
    if smem > SMEM_MAX:
        raise ValueError(f"knn_topk: D={D}, k={k} need {smem} bytes of "
                         f"shared memory, more than {SMEM_MAX}")
    chunk = max(TILE, -(-N // (TARGET_CHUNKS * TILE)) * TILE)
    n_chunks = -(-N // chunk)
    group = max(2, MERGE_PAIRS // kp)
    return dict(kp=kp, rt=rt, chunk=chunk, n_chunks=n_chunks, group=group,
                smem=smem)


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
    n0 = R * pl["n_chunks"] * pl["kp"]
    n1 = R * -(-pl["n_chunks"] // pl["group"]) * pl["kp"]
    ws = [torch.empty((max(1, n),), dtype=dt, device=dev)
          for n in (n0, n1) for dt in (torch.float32, torch.int32)]
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _cuda.function("knn_topk", "knn_topk",
                        [p] * 14 + [i32, i64, i32, i32, i32, i32, i64, i32,
                                    i32, i32, p])
    rc = fn(*(t.data_ptr() for t in (vecs, emb, *ints, out_d, out_g, *ws)),
            R, N, D, k, pl["kp"], pl["rt"], pl["chunk"], pl["n_chunks"],
            pl["group"], pl["smem"], _cuda.stream_of(vecs))
    _cuda.check(rc, "knn_topk")
    _cuda.LAUNCHES["knn_topk"] += 1
    return out_d, out_g
