"""The per-hop dedup/compact oracle in plain PyTorch (the ``ref`` backend).

Port of ``repro/kernels/dedup_compact/ref.py``: a library sort, then the
first-of-run mask and a scatter.  ``PAD`` (INT32_MAX) marks an invalid slot
and sorts last, so compacted rows stay ascending.  :func:`sort_pairs` is the
shared frontier's flat (seg, gid) pair sort.
"""
import torch

PAD = 2**31 - 1


def sort_rows(x):
    """Row-wise ascending sort of an (R, W) i32 matrix."""
    return torch.sort(x, dim=1).values


def pack_pairs(k1, k2):
    """One int64 per (k1, k2) int32 pair whose signed order is the pairs'
    lexicographic order: k1 in the high word, k2 biased by 2**31 into the
    low word.  The ghost pair (PAD, PAD) packs to the largest int64."""
    return (k1.long() << 32) + (k2.long() + 2**31)


def unpack_pairs(key):
    return ((key >> 32).to(torch.int32),
            ((key & 0xFFFFFFFF) - 2**31).to(torch.int32))


def sort_pairs(k1, k2):
    """Lexicographic ascending sort of flat (k1, k2) i32 pairs."""
    return unpack_pairs(torch.sort(pack_pairs(k1, k2)).values)


def dedup_compact_rows(x, cap: int):
    """(R, W) candidates -> ((R, cap) sorted-unique regions, (R,) counts).

    Row r's output is its first ``cap`` unique non-PAD values ascending, PAD
    beyond; ``counts`` is the number of uniques before capping."""
    R, W = x.shape
    if W == 0:
        return (torch.full((R, cap), PAD, dtype=torch.int32, device=x.device),
                torch.zeros((R,), dtype=torch.int32, device=x.device))
    x_s = torch.sort(x, dim=1).values
    return compact_sorted(x_s, cap)


def compact_sorted(x_s, cap: int):
    """Dedup/compact rows that are already sorted ascending."""
    R = x_s.shape[0]
    prev = torch.cat([torch.full((R, 1), -1, dtype=x_s.dtype,
                                 device=x_s.device), x_s[:, :-1]], dim=1)
    first = (x_s != PAD) & (x_s != prev)
    fi = first.to(torch.int32)
    n = fi.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(fi, dim=1, dtype=torch.int32) - fi
    col = torch.where(first & (rank < cap), rank, cap).long()
    out = torch.full((R, cap + 1), PAD, dtype=torch.int32, device=x_s.device)
    out.scatter_(1, col, x_s)
    return out[:, :cap], n
