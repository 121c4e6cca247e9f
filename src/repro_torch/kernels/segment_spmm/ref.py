"""ELL-format fused gather-GEMM in plain PyTorch (the oracle).

Port of ``repro/kernels/segment_spmm/ref.py``.
"""
import torch


def segment_spmm(x, ids, w=None, norm=None):
    """y[r] = (sum_k x[ids[r, k]]) * norm[r] @ w.

    x: (N, D) node features; ids: (R, K) i32 neighbor lists, -1 = padding;
    w: optional (D, Dout); norm: optional (R,) scale (e.g. 1/deg for GCN).
    Returns (R, Dout or D).
    """
    mask = ids >= 0
    safe = torch.where(mask, ids, 0).long()
    rows = x[safe] * mask[..., None].to(x.dtype)            # (R, K, D)
    agg = rows.sum(dim=1)
    if norm is not None:
        agg = agg * norm[:, None].to(x.dtype)
    if w is not None:
        agg = agg @ w
    return agg
