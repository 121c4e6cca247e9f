"""Attention for the transformer: the flash kernel, or the chunked
running-softmax recurrence in plain PyTorch.

Port of ``repro/models/attention.py::mha``.  The JAX module routes to the
Pallas kernel on a TPU and otherwise runs a ``lax.scan`` over kv chunks with
a running (max, denominator, accumulator); its ``constrain`` calls shard the
intermediates over a TPU mesh, and the port runs on one device, so it has
none.  Here the backend decides:

  * ``kernel`` — ``kernels/flash_attention/ops.py::mha``: the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors;
  * ``ref`` — :func:`chunked_mha`, the JAX recurrence over ``_CHUNK``-key
    chunks.
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import resolve
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF

_CHUNK = 2048      # flash-style kv chunk of the plain path
_ROWS = 4096       # query rows a pass (bounds the (B, H, rows, chunk) scores)


def mha(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
        backend=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) — GQA-aware."""
    if resolve(backend).is_kernel:
        return flash_ops.mha(q, k, v, causal, window, q_offset)
    return chunked_mha(q, k, v, causal=causal, window=window,
                       q_offset=q_offset)


def chunked_mha(q, k, v, *, causal: bool = True, window: int = 0,
                q_offset: int = 0):
    """The JAX package's plain path: kv chunks of ``_CHUNK`` keys (one chunk
    when Sk is not a multiple) and a running (max, denominator, acc) in
    float32.  Query rows go ``_ROWS`` at a time, which changes no row's
    arithmetic, and a chunk that the mask leaves empty for every row of a
    pass is skipped, which leaves the state as it was (p = 0, alpha = 1)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=1)
        v = torch.repeat_interleave(v, G, dim=1)
    C = min(_CHUNK, Sk)
    if Sk % C != 0:
        C = Sk
    out = torch.empty_like(q)
    kpos0 = torch.arange(C, device=q.device)
    for a in range(0, Sq, _ROWS):
        b = min(Sq, a + _ROWS)
        qf = q[:, :, a:b].float() * (D ** -0.5)
        qpos = torch.arange(a, b, device=q.device) + q_offset
        mx = torch.full((B, Hq, b - a, 1), NEG_INF, device=q.device)
        den = torch.zeros((B, Hq, b - a, 1), device=q.device)
        acc = torch.zeros((B, Hq, b - a, D), device=q.device)
        for c0 in range(0, Sk, C):
            if (causal and c0 > b - 1 + q_offset) or \
                    (window > 0 and c0 + C - 1 <= a + q_offset - window):
                continue
            kb = k[:, :, c0:c0 + C].float()
            vb = v[:, :, c0:c0 + C].float()
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
            kpos = c0 + kpos0
            msk = torch.ones((b - a, C), dtype=torch.bool, device=q.device)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                msk &= kpos[None, :] > (qpos[:, None] - window)
            s = torch.where(msk, s, NEG_INF)
            mx_new = torch.maximum(mx, torch.amax(s, dim=-1, keepdim=True))
            p = torch.where(msk, torch.exp(s - mx_new), 0.0)
            alpha = torch.exp(mx - mx_new)
            den = den * alpha + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
            mx = mx_new
        out[:, :, a:b] = (acc / torch.clamp(den, min=1e-30)).to(q.dtype)
    return out
