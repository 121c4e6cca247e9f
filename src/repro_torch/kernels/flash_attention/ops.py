"""The attention op of the model: the flash kernels, forward and backward.

Port of ``repro/kernels/flash_attention/ops.py`` (``mha``, ``_flatten``,
``_fwd_flat`` and the custom VJP ``_vjp_fwd`` / ``_vjp_bwd``): (B, H, S, D)
is flattened to (B*H, S, D) and the scale is ``D ** -0.5``.  The op is a
``torch.autograd.Function``: its forward runs ``flash_fwd`` and keeps q, k,
v, out and lse; its backward computes ``delta = sum(out * dout, -1)`` in
float32 (outside the kernels, as the JAX package does) and runs
``flash_bwd`` (the dQ and dK/dV kernels).  No gradient comes from plain
PyTorch autograd through the attention.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel


def _flatten(q, k, v):
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return (q.reshape(B * Hq, Sq, D), k.reshape(B * Hkv, Sk, D),
            v.reshape(B * Hkv, Sk, D))


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        qf, kf, vf = (t.contiguous() for t in _flatten(q, k, v))
        out, lse = _kernel.flash_fwd(qf, kf, vf, causal=causal,
                                     window=window, scale=q.shape[-1] ** -0.5,
                                     q_offset=q_offset)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.mask = (causal, window, q_offset)
        ctx.shapes = (q.shape, k.shape)
        return out.reshape(q.shape)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        q_shape, k_shape = ctx.shapes
        do = g.reshape(out.shape).contiguous()
        delta = torch.sum(out.float() * do.float(), dim=-1)
        dq, dk, dv = _kernel.flash_bwd(
            qf, kf, vf, do, lse, delta, causal=causal, window=window,
            scale=qf.shape[-1] ** -0.5, q_offset=q_offset)
        return (dq.reshape(q_shape), dk.reshape(k_shape),
                dv.reshape(k_shape), None, None, None)


def mha(q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0):
    """q: (B, Hq, S, D); k, v: (B, Hkv, Sk, D).  Flash attention."""
    return _MHA.apply(q, k, v, causal, window, q_offset)
