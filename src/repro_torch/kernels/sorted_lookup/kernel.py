"""Sorted-index probes: the CUDA kernels of ``csrc/sorted_lookup.cu`` and
their plain PyTorch versions.

Port of ``repro/kernels/sorted_lookup/kernel.py``:

  * ``searchsorted_left_ranged`` — for each query q, the left insertion
    point of ``queries[q]`` within its own window ``keys[lo[q]:hi[q]]``
    (clipped to the array), which is ``count(keys[lo:hi] < q)`` because each
    window is sorted ascending (the primary index, the shared frontier's
    runs);
  * ``searchsorted_left`` — the left insertion point of each query in one
    flat sorted array, ``count(keys < q)`` (a shard's index block in the
    SPMD probe).

The TPU kernels compare and count over every key; here the ranged kernel
and both plain versions binary-search, and the flat kernel searches 32-ary
with one warp a query (see the source for why), which gives the same count
on sorted keys.  Each wrapper runs the plain version for CPU tensors and
launches the kernel for CUDA tensors; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda


def searchsorted_left_ranged_plain(keys, queries, lo, hi):
    """Plain PyTorch version: the kernel's lower-bound search, vectorised
    over queries, run for a fixed ``bit_length(len(keys))`` halvings."""
    n = keys.shape[0]
    a = lo.long().clamp(min=0)
    b = torch.maximum(hi.long().clamp(max=n), a)
    base = a
    if n == 0:
        return torch.zeros_like(queries)
    for _ in range(max(1, n.bit_length())):
        active = a < b
        mid = a + ((b - a) >> 1)
        go = active & (keys[mid.clamp(max=n - 1)] < queries)
        a = torch.where(go, mid + 1, a)
        b = torch.where(active & ~go, mid, b)
    return (a - base).to(torch.int32)


def searchsorted_left_plain(keys, queries):
    """Plain PyTorch version: the kernel's lower-bound search over the
    whole array, vectorised over queries, run for a fixed
    ``bit_length(len(keys))`` halvings."""
    n = keys.shape[0]
    a = torch.zeros(queries.shape, dtype=torch.int64, device=queries.device)
    b = torch.full_like(a, n)
    if n == 0:
        return a.to(torch.int32)
    for _ in range(n.bit_length()):
        active = a < b
        mid = a + ((b - a) >> 1)
        go = active & (keys[mid.clamp(max=n - 1)] < queries)
        a = torch.where(go, mid + 1, a)
        b = torch.where(active & ~go, mid, b)
    return a.to(torch.int32)


def _check_1d(what: str, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 1-D int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")


def _check(keys, queries, lo, hi):
    _check_1d("searchsorted_left_ranged", keys=keys, queries=queries, lo=lo,
              hi=hi)
    if not (queries.shape == lo.shape == hi.shape):
        raise ValueError("searchsorted_left_ranged: queries, lo and hi must "
                         "have one shape")


def searchsorted_left_ranged(keys, queries, lo, hi):
    """keys (N,) i32 sorted within every window; queries/lo/hi (Q,) i32.
    Returns (Q,) i32 window-relative left insertion points."""
    _check(keys, queries, lo, hi)
    if keys.device.type == "cpu":
        return searchsorted_left_ranged_plain(keys, queries, lo, hi)
    _cuda.require_cuda(keys, queries, lo, hi)
    out = torch.empty_like(queries)
    if queries.numel() == 0:
        return out
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _cuda.function("sorted_lookup", "searchsorted_left_ranged",
                        [p, i64, p, p, p, p, i32, p])
    rc = fn(keys.data_ptr(), keys.shape[0], queries.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(), queries.shape[0],
            _cuda.stream_of(keys))
    _cuda.check(rc, "searchsorted_left_ranged")
    _cuda.LAUNCHES["searchsorted_left_ranged"] += 1
    return out


def searchsorted_left(keys, queries):
    """keys (N,) i32 sorted ascending (INT32_MAX pads sort last); queries
    (Q,) i32.  Returns (Q,) i32 left insertion points."""
    _check_1d("searchsorted_left", keys=keys, queries=queries)
    if keys.device.type == "cpu":
        return searchsorted_left_plain(keys, queries)
    _cuda.require_cuda(keys, queries)
    out = torch.empty_like(queries)
    if queries.numel() == 0:
        return out
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _cuda.function("sorted_lookup", "searchsorted_left",
                        [p, i64, p, p, i32, p])
    rc = fn(keys.data_ptr(), keys.shape[0], queries.data_ptr(),
            out.data_ptr(), queries.shape[0], _cuda.stream_of(keys))
    _cuda.check(rc, "searchsorted_left")
    _cuda.LAUNCHES["searchsorted_left"] += 1
    return out
