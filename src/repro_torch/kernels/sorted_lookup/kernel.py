"""Windowed sorted-index probe: the CUDA kernel ``csrc/sorted_lookup.cu`` and
its plain PyTorch version.

Port of ``repro/kernels/sorted_lookup/kernel.py::searchsorted_left_ranged``.
For each query q: the left insertion point of ``queries[q]`` within its own
window ``keys[lo[q]:hi[q]]`` (clipped to the array), which is
``count(keys[lo:hi] < q)`` because each window is sorted ascending.  The TPU
kernel compares and counts over every key; both versions here binary-search
the window instead (see the source for why), which gives the same count on
sorted windows.

:func:`searchsorted_left_ranged` runs the plain version for CPU tensors and
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


def _check(keys, queries, lo, hi):
    for name, t in (("keys", keys), ("queries", queries), ("lo", lo),
                    ("hi", hi)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"searchsorted_left_ranged: {name} must be a "
                             f"contiguous 1-D int32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
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
