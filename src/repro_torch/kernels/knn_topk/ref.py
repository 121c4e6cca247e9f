"""Batched k-NN: surrogate squared-L2 distance and per-query top-k, in plain
PyTorch (the ``ref`` backend, and the plain version of the CUDA kernel).

Port of ``repro/kernels/knn_topk/ref.py``.  For each query row it scores
every index entry with ``||e||^2 - 2<v, e>`` (+0.0, which turns -0.0 into
+0.0), keeps entries with ``gid >= 0``, the row's vertex type and
``create <= ts < delete``, and returns the ``k`` smallest by ``(dist, gid)``
ascending, ``(+inf, INT32_MAX)`` past the matches.

``jnp.dot`` promises no summation order, so this port fixes one and the CUDA
kernel ``csrc/knn_topk.cu`` uses the same: ``ee`` and ``ip`` are summed over
d = 0..D-1 in float32, each multiply and each add rounded on its own (one
``mul`` then one ``add`` tensor op per d, never a fused multiply-add).  The
two then agree bit for bit; against the JAX package the distances agree to
rounding (ROADMAP queue 3).
"""
from __future__ import annotations

import torch

I32MAX = 2**31 - 1
_LOW31 = 0x7FFFFFFF


def distances(vecs, emb):
    """(R, N) ``||e||^2 - 2<v, e> + 0.0`` in the fixed summation order."""
    R, D = vecs.shape
    N = emb.shape[0]
    ee = torch.zeros((N,), dtype=torch.float32, device=emb.device)
    ip = torch.zeros((R, N), dtype=torch.float32, device=emb.device)
    for d in range(D):
        e_d = emb[:, d]
        ee.add_(e_d * e_d)
        ip.add_(vecs[:, d:d + 1] * e_d[None, :])
    return (ee[None, :] - 2.0 * ip) + 0.0


def _order_key(d):
    """int32 whose signed order is the float order of ``d`` (no NaN)."""
    bits = d.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ _LOW31)


def _from_order_key(key):
    return torch.where(key >= 0, key, key ^ _LOW31).view(torch.float32)


def knn_topk(vecs, emb, gid, vtype, create, delete, q_vt, q_ts, k: int):
    """vecs (R, D) f32, emb (N, D) f32, gid/vtype/create/delete (N,) i32,
    q_vt/q_ts (R,) i32 -> (dist (R, k) f32, gids (R, k) i32)."""
    R = vecs.shape[0]
    N = emb.shape[0]
    dev = vecs.device
    out_d = torch.full((R, k), float("inf"), dtype=torch.float32, device=dev)
    out_g = torch.full((R, k), I32MAX, dtype=torch.int32, device=dev)
    n = min(k, N)
    if R == 0 or n == 0:
        return out_d, out_g
    ok = ((gid >= 0)[None, :] & (vtype[None, :] == q_vt[:, None])
          & (create[None, :] <= q_ts[:, None])
          & (q_ts[:, None] < delete[None, :]))
    d = torch.where(ok, distances(vecs.float(), emb.float()), float("inf"))
    g = torch.where(ok, gid[None, :], I32MAX)
    # one int64 key per entry, ordered as (dist, gid): the k smallest keys
    # are the k smallest pairs, and equal keys are equal pairs
    key = (_order_key(d).long() << 32) + (g.long() + 2**31)
    top = torch.topk(key, n, dim=1, largest=False, sorted=True).values
    out_d[:, :n] = _from_order_key((top >> 32).to(torch.int32))
    out_g[:, :n] = ((top & 0xFFFFFFFF) - 2**31).to(torch.int32)
    return out_d, out_g
