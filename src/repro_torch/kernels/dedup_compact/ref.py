"""The per-hop dedup/compact oracle in plain PyTorch (the ``ref`` backend).

Port of ``repro/kernels/dedup_compact/ref.py``: a library sort, then the
first-of-run mask and a scatter.  ``PAD`` (INT32_MAX) marks an invalid slot
and sorts last, so compacted rows stay ascending.
"""
import torch

PAD = 2**31 - 1


def sort_rows(x):
    """Row-wise ascending sort of an (R, W) i32 matrix."""
    return torch.sort(x, dim=1).values


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
