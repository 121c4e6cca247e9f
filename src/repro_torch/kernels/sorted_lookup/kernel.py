"""Sorted-index probes: the CUDA kernels of ``csrc/sorted_lookup.cu`` and
their plain PyTorch versions.

Port of ``repro/kernels/sorted_lookup/kernel.py``:

  * ``searchsorted_left_ranged`` — for each query q, the left insertion
    point of ``queries[q]`` within its own window ``keys[lo[q]:hi[q]]``
    (clipped to the array; ``hi = lo + width`` when a scalar ``width`` is
    given instead), which is ``count(keys[lo:hi] < q)`` because each window
    is sorted ascending (the primary index, the shared frontier's runs);
  * ``searchsorted_left`` — the left insertion point of each query in one
    flat sorted array, ``count(keys < q)`` (a shard's index block in the
    SPMD probe).

The TPU kernels compare and count over every key; here both kernels search
32-ary with one warp a query (see the source for why) and both plain
versions binary-search, which gives the same count on sorted keys.  Each
wrapper runs the plain version for CPU tensors and launches the kernel for
CUDA tensors; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_RANGED_ARGS = [_P, _I64, _P, _P, _P, _P, _I32, _P]
_WIDTH_ARGS = [_P, _I64, _P, _P, _I64, _P, _I32, _P]
_LEFT_ARGS = [_P, _I64, _P, _P, _I32, _P]
_NAMES = ("keys", "queries", "lo", "hi")


def _lower_bound(keys, queries, a, b):
    """The first index in [a, b] whose key is >= its query, by a binary
    search run for a fixed ``bit_length(len(keys))`` halvings (int64)."""
    n = keys.shape[0]
    for _ in range(max(1, n.bit_length())):
        active = a < b
        mid = a + ((b - a) >> 1)
        go = active & (keys[mid.clamp(max=n - 1)] < queries)
        a = torch.where(go, mid + 1, a)
        b = torch.where(active & ~go, mid, b)
    return a


def searchsorted_left_ranged_plain(keys, queries, lo, hi=None, *,
                                   width=None):
    """Plain PyTorch version: a lower-bound search inside each clipped
    window, vectorised over queries."""
    n = keys.shape[0]
    a = lo.long().clamp(min=0)
    if n == 0:
        return torch.zeros_like(queries)
    end = lo.long() + width if hi is None else hi.long()
    b = torch.maximum(end.clamp(max=n), a)
    return (_lower_bound(keys, queries, a, b) - a).to(torch.int32)


def searchsorted_left_plain(keys, queries):
    """Plain PyTorch version: the lower-bound search over the whole
    array, vectorised over queries."""
    n = keys.shape[0]
    a = torch.zeros(queries.shape, dtype=torch.int64, device=queries.device)
    if n == 0:
        return a.to(torch.int32)
    return _lower_bound(keys, queries, a, torch.full_like(a, n)).to(
        torch.int32)


def _check(what: str, *tensors) -> bool:
    """One pass over the inputs (keys, queries, lo, hi in that order): each
    a contiguous 1-D int32 tensor, all on the CPU (True: run the plain
    version) or all on one CUDA device (False); anything else raises."""
    dev = tensors[0].get_device()            # -1 on the CPU
    for i, t in enumerate(tensors):
        if t.dtype is not torch.int32 or t.dim() != 1 or \
                not t.is_contiguous():
            raise ValueError(f"{what}: {_NAMES[i]} must be a contiguous 1-D "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
        if t.get_device() != dev:
            dev = None
    if dev is None or not (tensors[0].is_cuda or all(
            t.is_cpu for t in tensors)):
        raise ValueError(f"{what}: the inputs must all lie on the CPU or on "
                         f"one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev < 0


def _check_ranged(keys, queries, lo, hi, width) -> bool:
    if hi is None:
        if width is None:
            raise ValueError("searchsorted_left_ranged: give hi or width")
        on_cpu = _check("searchsorted_left_ranged", keys, queries, lo)
    else:
        if width is not None:
            raise ValueError("searchsorted_left_ranged: give hi or width, "
                             "not both")
        on_cpu = _check("searchsorted_left_ranged", keys, queries, lo, hi)
        if hi.shape[0] != queries.shape[0]:
            raise ValueError("searchsorted_left_ranged: queries, lo and hi "
                             "must have one shape")
    if lo.shape[0] != queries.shape[0]:
        raise ValueError("searchsorted_left_ranged: queries, lo and hi must "
                         "have one shape")
    return on_cpu


def searchsorted_left_ranged(keys, queries, lo, hi=None, *, width=None):
    """keys (N,) i32 sorted within every window; queries/lo/hi (Q,) i32, or
    ``width`` (an int) for the windows [lo, lo + width).  Returns (Q,) i32
    window-relative left insertion points."""
    if _check_ranged(keys, queries, lo, hi, width):
        return searchsorted_left_ranged_plain(keys, queries, lo, hi,
                                              width=width)
    out = torch.empty_like(queries)
    n_queries = queries.shape[0]
    if n_queries == 0:
        return out
    if hi is None:      # one C entry for each form: no null pointer to pass
        fn = _cuda.function("sorted_lookup", "searchsorted_left_width",
                            _WIDTH_ARGS)
        rc = fn(keys.data_ptr(), keys.shape[0], queries.data_ptr(),
                lo.data_ptr(), width, out.data_ptr(), n_queries,
                _cuda.stream_of(keys))
    else:
        fn = _cuda.function("sorted_lookup", "searchsorted_left_ranged",
                            _RANGED_ARGS)
        rc = fn(keys.data_ptr(), keys.shape[0], queries.data_ptr(),
                lo.data_ptr(), hi.data_ptr(), out.data_ptr(), n_queries,
                _cuda.stream_of(keys))
    _cuda.check(rc, "searchsorted_left_ranged")
    _cuda.LAUNCHES["searchsorted_left_ranged"] += 1
    return out


def searchsorted_left(keys, queries):
    """keys (N,) i32 sorted ascending (INT32_MAX pads sort last); queries
    (Q,) i32.  Returns (Q,) i32 left insertion points."""
    if _check("searchsorted_left", keys, queries):
        return searchsorted_left_plain(keys, queries)
    out = torch.empty_like(queries)
    if queries.shape[0] == 0:
        return out
    fn = _cuda.function("sorted_lookup", "searchsorted_left", _LEFT_ARGS)
    rc = fn(keys.data_ptr(), keys.shape[0], queries.data_ptr(),
            out.data_ptr(), queries.shape[0], _cuda.stream_of(keys))
    _cuda.check(rc, "searchsorted_left")
    _cuda.LAUNCHES["searchsorted_left"] += 1
    return out
