"""Embedding-bag: the CUDA kernel ``csrc/embedding_bag.cu`` and its plain
PyTorch version.

Port of ``repro/kernels/embedding_bag/kernel.py::embedding_bag``: for each
bag b, ``out[b] = sum_l table[ids[b, l]]`` over the slots l = 0..L-1 in
order, summed in float32; ids < 0 are padding and add nothing.  In
``"mean"`` mode the f32 sum is divided in f32 by max(count, 1), count the
bag's non-padding ids (an empty bag gives 0).  The result is cast to the
table's dtype (float32 or bfloat16).  :func:`embedding_bag` runs the plain
version for CPU tensors and launches the kernel for CUDA tensors.  Ids
must be below V; the kernel skips any that are not, the plain version
raises on them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda

MODES = ("sum", "mean")


def embedding_bag_plain(table, ids, *, mode: str = "sum"):
    """Plain PyTorch version: the kernel's arithmetic, one slot at a time
    in order, in f32."""
    _check(table, ids, mode)
    B, L = ids.shape
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    mask = ids >= 0
    safe = torch.where(mask, ids, 0).long()
    for l in range(L):
        acc += torch.where(mask[:, l, None], table[safe[:, l]].float(), 0.0)
    if mode == "mean":
        acc = acc / torch.clamp(mask.sum(dim=1, keepdim=True), min=1).float()
    return acc.to(table.dtype)


def _check(table, ids, mode):
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, got "
                         f"{mode!r}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embedding_bag: the table must be float32 or "
                         f"bfloat16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"embedding_bag: ids must be int32, got {ids.dtype}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} must be "
                         f"(V, D) and ids {tuple(ids.shape)} (B, L)")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag: inputs must be contiguous")


def embedding_bag(table, ids, *, mode: str = "sum"):
    """table: (V, D) float32 or bfloat16; ids: (B, L) int32, -1 = padding.
    Returns (B, D) in the table's dtype."""
    _check(table, ids, mode)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, mode=mode)
    _cuda.require_cuda(table, ids)
    (V, D), B = table.shape, ids.shape[0]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    p = ctypes.c_void_p
    fn = _cuda.function("embedding_bag", "embedding_bag",
                        [p, p, p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, p])
    rc = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), V, D, B,
            ids.shape[1], int(mode == "mean"), _cuda.dtype_code(table),
            _cuda.stream_of(table))
    _cuda.check(rc, "embedding_bag")
    _cuda.LAUNCHES["embedding_bag"] += 1
    return out
