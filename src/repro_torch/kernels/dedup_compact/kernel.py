"""Row-wise sort, dedup/compaction and the flat pair sort: the CUDA kernels
``csrc/dedup_compact.cu`` and ``csrc/sort_pairs.cu`` and their plain
PyTorch versions.

Port of ``repro/kernels/dedup_compact/kernel.py::sort_rows``,
``::dedup_compact_rows`` and ``::sort_pairs``.  Every version sorts with the
same ascending-only bitonic network (the plain versions pad to a power of
two with the largest value; the kernels pad only virtually).  The dedup
keeps the first of each run of equal non-PAD values, compacted by a prefix
sum; the pair sort runs the network over one packed int64 key a pair.  The
wrappers run the plain version for CPU tensors and launch the kernel for
CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.dedup_compact.ref import (PAD, compact_sorted,
                                                  pack_pairs, unpack_pairs)

# widest row the kernel holds in one block's shared memory (227 KB, less the
# scan's scratch): 4 bytes a column
MAX_W = (232_448 - 1_024) // 4
# widest flat pair sort: the network's comparator indices stay in an int
MAX_PAIRS = 1 << 30


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _bitonic_rows(x, pad=PAD):
    """Ascending-only bitonic network along axis 1 (the kernels' network);
    ``pad`` must be the dtype's largest value."""
    R, W = x.shape
    W2 = _pow2ceil(W)
    if W2 > W:
        x = torch.cat([x, torch.full((R, W2 - W), pad, dtype=x.dtype,
                                     device=x.device)], dim=1)
    idx = torch.arange(W2, device=x.device)
    k = 2
    while k <= W2:
        j = k // 2
        while j >= 1:
            partner = idx ^ (k - 1) if j == k // 2 else idx ^ j
            px = x[:, partner]
            x = torch.where(idx < partner, torch.minimum(x, px),
                            torch.maximum(x, px))
            j //= 2
        k *= 2
    return x[:, :W]


def sort_rows_plain(x):
    return _bitonic_rows(x)


def dedup_compact_rows_plain(x, cap: int):
    R, W = x.shape
    if W == 0:
        return (torch.full((R, cap), PAD, dtype=torch.int32, device=x.device),
                torch.zeros((R,), dtype=torch.int32, device=x.device))
    return compact_sorted(_bitonic_rows(x), cap)


def sort_pairs_plain(k1, k2):
    """The kernel's network over the packed int64 keys of the pairs."""
    key = pack_pairs(k1, k2)[None, :]
    return unpack_pairs(_bitonic_rows(key, torch.iinfo(torch.int64).max)[0])


def _check(x, what: str):
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (R, W) int32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _check_width(W: int, what: str):
    if W > MAX_W:
        raise ValueError(f"{what}: row width {W} exceeds the {MAX_W} columns "
                         "one block holds in shared memory")


def sort_rows(x):
    """Row-wise ascending sort of an (R, W) i32 matrix."""
    _check(x, "sort_rows")
    if x.device.type == "cpu":
        return sort_rows_plain(x)
    _cuda.require_cuda(x)
    R, W = x.shape
    _check_width(W, "sort_rows")
    out = torch.empty_like(x)
    if R == 0 or W == 0:
        return out
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function("dedup_compact", "sort_rows",
                        [p, p, i32, i32, i32, p])
    rc = fn(x.data_ptr(), out.data_ptr(), R, W, _pow2ceil(W),
            _cuda.stream_of(x))
    _cuda.check(rc, "sort_rows")
    _cuda.LAUNCHES["sort_rows"] += 1
    return out


def dedup_compact_rows(x, cap: int):
    """(R, W) candidates (PAD = invalid) -> ((R, cap) sorted-unique regions,
    (R,) unique counts before the cap)."""
    _check(x, "dedup_compact_rows")
    if x.device.type == "cpu":
        return dedup_compact_rows_plain(x, cap)
    _cuda.require_cuda(x)
    R, W = x.shape
    _check_width(W, "dedup_compact_rows")
    out = torch.empty((R, cap), dtype=torch.int32, device=x.device)
    counts = torch.empty((R,), dtype=torch.int32, device=x.device)
    if R == 0:
        return out, counts
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function("dedup_compact", "dedup_compact_rows",
                        [p, p, p, i32, i32, i32, i32, p])
    rc = fn(x.data_ptr(), out.data_ptr(), counts.data_ptr(), R, W,
            _pow2ceil(W), cap, _cuda.stream_of(x))
    _cuda.check(rc, "dedup_compact_rows")
    _cuda.LAUNCHES["dedup_compact_rows"] += 1
    return out, counts


def sort_pairs(k1, k2):
    """Lexicographic ascending sort of flat (k1, k2) i32 pairs; ==
    ``jax.lax.sort((k1, k2), num_keys=2)``."""
    for name, t in (("k1", k1), ("k2", k2)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"sort_pairs: {name} must be a contiguous 1-D "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if k1.shape != k2.shape:
        raise ValueError("sort_pairs: k1 and k2 must have one shape")
    if k1.device.type == "cpu":
        return sort_pairs_plain(k1, k2)
    _cuda.require_cuda(k1, k2)
    W = k1.shape[0]
    if W > MAX_PAIRS:
        raise ValueError(f"sort_pairs: {W} pairs exceed {MAX_PAIRS}")
    o1, o2 = torch.empty_like(k1), torch.empty_like(k2)
    if W == 0:
        return o1, o2
    buf = torch.empty((W,), dtype=torch.int64, device=k1.device)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function("sort_pairs", "sort_pairs", [p, p, p, p, p, i32, p])
    rc = fn(k1.data_ptr(), k2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
            buf.data_ptr(), W, _cuda.stream_of(k1))
    _cuda.check(rc, "sort_pairs")
    _cuda.LAUNCHES["sort_pairs"] += 1
    return o1, o2
