"""Embedding-bag in plain PyTorch (the oracle).

Port of ``repro/kernels/embedding_bag/ref.py``: a gather and a masked
reduction in the table's dtype.  In bfloat16 mean mode it divides the
bf16 sum in bf16, where the kernel divides its f32 sum in f32; the port's
kernel and its plain version follow the JAX kernel.
"""
import torch


def embedding_bag(table, ids, *, mode: str = "sum"):
    """table: (V, D); ids: (B, L) i32, -1 = padding.  Returns (B, D).

    mode: 'sum' | 'mean' (mean over non-padding entries; empty bag -> 0).
    """
    mask = ids >= 0
    safe = torch.where(mask, ids, 0).long()
    rows = table[safe] * mask[..., None].to(table.dtype)      # (B, L, D)
    out = rows.sum(dim=1)
    if mode == "mean":
        n = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        out = out / n.to(table.dtype)
    return out
