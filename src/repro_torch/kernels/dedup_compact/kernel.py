"""Row-wise sort, dedup/compaction and the flat pair sort: the CUDA kernels
``csrc/dedup_compact.cu`` and ``csrc/sort_pairs.cu`` and their plain
PyTorch versions.

Port of ``repro/kernels/dedup_compact/kernel.py::sort_rows``,
``::dedup_compact_rows`` and ``::sort_pairs``.  ``sort_rows`` and
``dedup_compact_rows`` run one routine, as do their plain versions
(:func:`sort_rows_plain`): drop PAD and sort each row's valid keys by a
least-significant-digit radix sort of (key - row min), 8 bits a pass and
only the passes the row's range needs (:func:`dedup_passes`).  The sort
then writes PAD after the valid keys (PAD sorts last and its copies are
equal bits, so this is ``torch.sort``'s result); the dedup keeps the first
of each run of equal values, compacted by a prefix sum.  The pair sort
packs each pair into one 64-bit key and runs a least-significant-digit
radix sort over its eight 8-bit digits, skipping the digits that are
constant over the input (a width up to ``SMALL_MAX`` takes the kernel's
one-block bitonic sort instead: the same result).  The wrappers run the
plain version for CPU tensors and launch the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.dedup_compact.ref import (PAD, compact_sorted,
                                                  pack_pairs, unpack_pairs)

# widest row of sort_rows and dedup_compact_rows: the radix routine's
# 16-bit per-warp digit counts need W below 2**16 (the value is the width
# the earlier row-resident sort held in one block's shared memory)
MAX_W = (232_448 - 1_024) // 4
# widest flat pair sort: positions stay in an int, and a bucket's count
# below it fits the 30 bits a look-back word gives it
MAX_PAIRS = 1 << 30
# the radix sort's shapes (csrc/sort_pairs.cu): keys a pass tile, keys a
# histogram block, the most histogram blocks the scratch is sized for (the
# kernel may use fewer), 8-bit digits
TILE = 256 * 8
HIST_KEYS = 1024 * 4
HIST_MAX_BLOCKS = 1024
DIGITS, RADIX = 8, 256
# widths up to SMALL_MAX take the kernel's one-block bitonic sort (one
# launch, kSmallMax in the source) and need no scratch: on an H100 it took
# less time a call than the radix sort's nine launches up to 4,096 pairs
SMALL_MAX = 4096
_SIGN64 = -2**63
# the radix routine's shapes (csrc/dedup_compact.cu, both kernels): a
# block's threads (256 for rows up to DEDUP_SMALL_W columns), the shared
# memory a block may use, and the words of reduction scratch beside the
# digit counts
DEDUP_THREADS, DEDUP_THREADS_SMALL, DEDUP_SMALL_W = 1024, 256, 2048
SMEM_MAX = 232_448
DEDUP_RED = 128


def dedup_passes(x):
    """The digit passes the radix routine (sort and dedup) runs on each row
    of ``x``: as many 8-bit digits as (max - min) of the row's valid
    (non-PAD) keys has, 0 for a row with at most one distinct valid key."""
    valid = x != PAD
    xl = x.long()
    mn = torch.where(valid, xl, 2**40).amin(dim=1)
    mx = torch.where(valid, xl, -2**40).amax(dim=1)
    span = mx - mn
    return sum((span >= 256 ** d).long() for d in range(4))


def sort_rows_plain(x):
    """The kernels' shared routine (the sort's whole algorithm): drop PAD
    (the valid keys first, in order), then for each digit pass of the row,
    least significant first, a stable reorder by that digit of (key - row
    min); PAD stays last."""
    R, W = x.shape
    if R == 0 or W == 0:
        return x.clone()
    valid = x != PAD
    passes = dedup_passes(x)
    mn = torch.where(valid, x.long(), 2**40).amin(dim=1, keepdim=True)
    o = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    xs, valid = x.gather(1, o), valid.gather(1, o)
    for d in range(int(passes.max())):
        run = (passes > d)[:, None] & valid
        digit = torch.where(run, ((xs.long() - mn) >> (8 * d)) & (RADIX - 1),
                            torch.where(valid, 0, RADIX))
        o = torch.argsort(digit, dim=1, stable=True)
        xs, valid = xs.gather(1, o), valid.gather(1, o)
    return xs


def dedup_compact_rows_plain(x, cap: int):
    """The kernel's algorithm: the radix sort of the valid keys, then the
    first-of-run compaction."""
    R, W = x.shape
    if R == 0 or W == 0:
        return (torch.full((R, cap), PAD, dtype=torch.int32, device=x.device),
                torch.zeros((R,), dtype=torch.int32, device=x.device))
    return compact_sorted(sort_rows_plain(x), cap)


def dedup_key_cap(W: int) -> int:
    """Keys a sort or dedup block holds in shared memory (csrc
    ``key_cap``): what is left of ``fixed_bytes`` + 8 W, at most SMEM_MAX,
    after the per-warp digit counts, the bucket starts and the scratch
    words."""
    threads = DEDUP_THREADS_SMALL if W <= DEDUP_SMALL_W else DEDUP_THREADS
    fixed = threads // 32 * RADIX * 2 + RADIX * 4 + DEDUP_RED * 4
    return (min(fixed + 8 * W, SMEM_MAX) - fixed) // 4


def dedup_scratch_words(R: int, W: int) -> int:
    """Words of the dedup kernel's scratch: none when two buffers of W keys
    fit in shared memory, else a row of W for the second buffer, and
    another when one buffer of W does not fit either."""
    cap = dedup_key_cap(W)
    return 0 if 2 * W <= cap else R * W * (1 if W <= cap else 2)


def sort_scratch_words(R: int, W: int) -> int:
    """Words of the sort kernel's scratch: none when two buffers of W keys
    fit in shared memory, else a row of W for the second buffer (the first,
    when it does not fit either, is the output row)."""
    return 0 if 2 * W <= dedup_key_cap(W) else R * W


def radix_keys(k1, k2):
    """The kernel's 64-bit keys as int64 bits: (k1 ^ 2^31) << 32 |
    (k2 ^ 2^31), whose unsigned order is the pairs' lexicographic order."""
    return pack_pairs(k1, k2) ^ _SIGN64


def radix_digit(key, d: int):
    """Digit d (bits 8d to 8d + 7) of each key."""
    return (key >> (8 * d)) & (RADIX - 1)


def radix_mask(key) -> int:
    """The digits that vary over the keys (bit d): the passes that run."""
    if key.shape[0] == 0:
        return 0
    return sum(1 << d for d in range(DIGITS)
               if not bool((radix_digit(key, d) == radix_digit(
                   key[:1], d)).all()))


def sort_pairs_plain(k1, k2):
    """The kernel's radix sort: for each digit that varies, least
    significant first, a stable reorder of the keys by that digit (what
    each pass's counting scatter gives)."""
    key = radix_keys(k1, k2)
    mask = radix_mask(key)
    for d in range(DIGITS):
        if mask >> d & 1:
            key = key[torch.argsort(radix_digit(key, d), stable=True)]
    return unpack_pairs(key ^ _SIGN64)


def radix_scratch_bytes(W: int) -> int:
    """Bytes of the radix sort's scratch (``csrc/sort_pairs.cu``'s
    ``make_layout``): two key buffers, the histogram blocks' counts, a
    32-word header (a counter, the mask, the tile counters), the digits'
    bucket totals and the look-back words of the eight passes; sized for
    HIST_MAX_BLOCKS histogram blocks, the most the kernel uses."""
    n_tiles = -(-W // TILE)
    n_hist = min(-(-W // HIST_KEYS), HIST_MAX_BLOCKS)
    return 16 * W + 4 * (n_hist * DIGITS * RADIX + 32 + DIGITS * RADIX
                         + DIGITS * n_tiles * RADIX)


def _check(x, what: str):
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (R, W) int32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _check_width(W: int, what: str):
    if W > MAX_W:
        raise ValueError(f"{what}: row width {W} exceeds the {MAX_W} columns "
                         "one block holds in shared memory")


def sort_rows(x):
    """Row-wise ascending sort of an (R, W) i32 matrix.  On CUDA the output
    and the kernel's scratch are one allocation."""
    _check(x, "sort_rows")
    if x.device.type == "cpu":
        return sort_rows_plain(x)
    _cuda.require_cuda(x)
    R, W = x.shape
    _check_width(W, "sort_rows")
    n_scratch = sort_scratch_words(R, W)          # 0, or R rows of W
    buf = torch.empty((2 * R if n_scratch else R, W), dtype=torch.int32,
                      device=x.device)
    out = buf[:R]
    if R == 0 or W == 0:
        return out
    fn = _cuda.function("dedup_compact", "sort_rows", _SORT_ARGS)
    rc = fn(x.data_ptr(), out.data_ptr(), buf.data_ptr() + 4 * R * W,
            n_scratch, R, W, _cuda.stream_of(x))
    _cuda.check(rc, "sort_rows")
    _cuda.LAUNCHES["sort_rows"] += 1
    return out


_SORT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]


def dedup_compact_rows(x, cap: int):
    """(R, W) candidates (PAD = invalid) -> ((R, cap) sorted-unique regions,
    (R,) unique counts before the cap).  On CUDA the outputs and the
    kernel's scratch are one allocation."""
    _check(x, "dedup_compact_rows")
    if x.device.type == "cpu":
        return dedup_compact_rows_plain(x, cap)
    _cuda.require_cuda(x)
    R, W = x.shape
    _check_width(W, "dedup_compact_rows")
    n_scratch = dedup_scratch_words(R, W)
    buf = torch.empty((R * cap + R + n_scratch,), dtype=torch.int32,
                      device=x.device)
    out, counts = buf[:R * cap].view(R, cap), buf[R * cap:R * cap + R]
    if R == 0:
        return out, counts
    fn = _cuda.function("dedup_compact", "dedup_compact_rows", _DEDUP_ARGS)
    rc = fn(x.data_ptr(), out.data_ptr(), counts.data_ptr(),
            buf.data_ptr() + 4 * (R * cap + R), n_scratch, R, W, cap,
            _cuda.stream_of(x))
    _cuda.check(rc, "dedup_compact_rows")
    _cuda.LAUNCHES["dedup_compact_rows"] += 1
    return out, counts


_DEDUP_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check_pairs(k1, k2) -> bool:
    """One pass over the inputs: contiguous 1-D int32 tensors of one shape,
    both on the CPU (True: run the plain version) or on one CUDA device
    (False); anything else raises."""
    for name, t in (("k1", k1), ("k2", k2)):
        if t.dtype is not torch.int32 or t.dim() != 1 or \
                not t.is_contiguous():
            raise ValueError(f"sort_pairs: {name} must be a contiguous 1-D "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if k1.shape[0] != k2.shape[0]:
        raise ValueError("sort_pairs: k1 and k2 must have one shape")
    if k1.is_cpu:
        return True
    _cuda.require_cuda(k1, k2)
    if k1.shape[0] > MAX_PAIRS:
        raise ValueError(f"sort_pairs: {k1.shape[0]} pairs exceed "
                         f"{MAX_PAIRS}")
    return False


def sort_pairs(k1, k2):
    """Lexicographic ascending sort of flat (k1, k2) i32 pairs; ==
    ``jax.lax.sort((k1, k2), num_keys=2)``.  On CUDA the outputs and the
    radix sort's scratch are one allocation (the outputs are its first 2 W
    words)."""
    if _check_pairs(k1, k2):
        return sort_pairs_plain(k1, k2)
    W = k1.shape[0]
    radix = W > SMALL_MAX
    nbytes = radix_scratch_bytes(W) if radix else 0
    buf = torch.empty((2 * W + nbytes // 4,), dtype=torch.int32,
                      device=k1.device)
    o1, o2 = buf[:2 * W].view(2, W)
    if W == 0:
        return o1, o2
    fn = _cuda.function("sort_pairs", "sort_pairs", _PAIRS_ARGS)
    rc = fn(k1.data_ptr(), k2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
            buf.data_ptr() + 8 * W if radix else None, nbytes, W,
            _cuda.stream_of(k1))
    _cuda.check(rc, "sort_pairs")
    _cuda.LAUNCHES["sort_pairs"] += 1
    return o1, o2


_PAIRS_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]
