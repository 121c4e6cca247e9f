"""Gradient compression: int8 quantization with error feedback.

Port of ``repro/optim/compression.py``: a gradient is quantized to int8
with a per-tensor scale after the carried error is added, and the
quantization error is carried to the next step.  With ``axis_name`` the
int8 payloads are summed over the mesh (the JAX package's psum inside
``shard_map``), in lockstep form: the caller passes one gradient tree and
one error tree a shard, and gets one of each a shard back.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.dist.mesh import psum


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
    (decompressed grads in the grads' dtypes, new error state).

    With ``axis_name`` (a name for the mesh axis, as in JAX; one device
    holds the whole mesh) ``grads`` and ``error_state`` are lists of
    per-shard trees, and so are the results: shard s's gradient is the
    sum over shards of the int8 payloads, in int32, times shard s's own
    scale, over the shard count (JAX's arithmetic, which weighs every
    payload by the local scale: ROADMAP queue 3).  Without it the tree is
    one shard's: its own payload times its scale."""
    if axis_name is None:
        g, e = _ef_lockstep([grads], [error_state])
        return g[0], e[0]
    return _ef_lockstep(grads, error_state)


def _ef_lockstep(grads: list, error_state: list):
    S = len(grads)

    def one(*ge):       # a tuple: a leaf to tree_map, where a list is not
        gs, es = ge[:S], ge[S:]
        gfs = [g.float() + e for g, e in zip(gs, es)]
        qs = [compress_int8(gf) for gf in gfs]
        qsum = psum([q.int() for q, _ in qs])
        return tuple((((qt.float() * scale) / float(S)).to(g.dtype),
                      gf - decompress_int8(q, scale))
                     for g, gf, (q, scale), qt in zip(gs, gfs, qs, qsum))

    per = tree_map(one, *grads, *error_state)
    return ([tree_map(lambda r: r[s][0], per) for s in range(S)],
            [tree_map(lambda r: r[s][1], per) for s in range(S)])


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
