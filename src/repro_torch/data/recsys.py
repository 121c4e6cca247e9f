"""Synthetic BST batches (user behavior sequences + CTR labels).

Port of ``repro/data/recsys.py``: the same numpy draws, so that a seed
gives the same arrays bit for bit, as tensors on the device (the GPU
unless the caller passes ``device``); :func:`bst_batch_shape_dtypes` gives
the dry run's ``meta`` tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import resolve_device


def bst_batch(*, batch: int, seq_len: int = 20, n_items: int = 1_000_000,
              n_dense: int = 8, seed: int = 0, device=None):
    """(hist (B, seq_len) i32, target (B,) i32, dense (B, n_dense) f32,
    labels (B,) f32)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # zipf item popularity (huge_embedding regime)
    hist = (rng.zipf(1.3, size=(batch, seq_len)) % n_items).astype(np.int32)
    target = (rng.zipf(1.3, size=(batch,)) % n_items).astype(np.int32)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    labels = (rng.uniform(size=batch) < 0.2).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (hist, target, dense, labels))


def bst_batch_shape_dtypes(*, batch: int, seq_len: int = 20,
                           n_dense: int = 8):
    """:func:`bst_batch`'s tensors on ``meta`` (the dry run's shapes)."""
    return tuple(torch.empty(s, dtype=d, device="meta") for s, d in (
        ((batch, seq_len), torch.int32), ((batch,), torch.int32),
        ((batch, n_dense), torch.float32), ((batch,), torch.float32)))
