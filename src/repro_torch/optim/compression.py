"""Gradient compression: int8 quantization with error feedback.

Port of ``repro/optim/compression.py``: a gradient is quantized to int8
with a per-tensor scale after the carried error is added, and the
quantization error is carried to the next step.  On one device there is no
all-reduce to shrink: ``axis_name`` (the JAX package's psum of the int8
payload inside ``shard_map``) raises until the fleet is ported.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map

FLEET_ITEM = "ROADMAP queue 1 item 12b (the fleet across cards: NCCL)"


def compress_int8(x):
    """x (f32/bf16) -> (int8 values, f32 scale)."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def ef_compress_grads(grads, error_state, axis_name=None):
    """Error-feedback int8 compression of a gradient tree: returns
    (decompressed grads in the grads' dtypes, new error state)."""
    if axis_name is not None:
        raise NotImplementedError(
            f"ef_compress_grads over a mesh axis is not ported yet: "
            f"{FLEET_ITEM}")

    def one(g, e):
        gf = g.float() + e
        q, scale = compress_int8(gf)
        deq = decompress_int8(q, scale)
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, error_state)
    return (tree_map(lambda t: t[0], out),
            tree_map(lambda t: t[1], out))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
