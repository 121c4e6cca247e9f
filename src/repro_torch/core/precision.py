"""Matmul precision: float32 products that sum in float32, as XLA's do.

PyTorch on a GPU may take TF32 for float32 matmuls and a reduced-precision
reduction for bfloat16 ones when a caller allows it; the JAX package's XLA
never does.  :func:`f32_accumulation` turns both off for its duration and
restores the caller's flags.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_accumulation():
    """Matmuls that sum in f32, as XLA does: no TF32 for f32 inputs and no
    reduced-precision reduction for bf16 ones (PyTorch's default allows
    it).  The flags are process-wide, so they are restored on the way
    out.  Usable as a decorator."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved
