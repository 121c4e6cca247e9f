"""The attention op of the model: the flash kernel, forward only.

Port of ``repro/kernels/flash_attention/ops.py`` (``mha``, ``_flatten``,
``_fwd_flat``) for serving: (B, H, S, D) is flattened to (B*H, S, D) and
the scale is ``D ** -0.5``.  The JAX op has a custom VJP (the ``flash_bwd``
kernels); this slice serves, so the op is a ``torch.autograd.Function``
whose backward raises until the training slice ports ``flash_bwd``
(ROADMAP queue 1 item 15b): no gradient comes silently from plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.rmsnorm.ops import TRAINING_ITEM


def _flatten(q, k, v):
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return (q.reshape(B * Hq, Sq, D), k.reshape(B * Hkv, Sk, D),
            v.reshape(B * Hkv, Sk, D))


def _fwd_flat(q, k, v, causal, window, q_offset):
    B, Hq, Sq, D = q.shape
    qf, kf, vf = (t.contiguous() for t in _flatten(q, k, v))
    out, lse = _kernel.flash_fwd(qf, kf, vf, causal=causal, window=window,
                         scale=D ** -0.5, q_offset=q_offset)
    return out.reshape(q.shape), lse.reshape(B, Hq, Sq)


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        return _fwd_flat(q, k, v, causal, window, q_offset)[0]

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"flash_bwd is not ported yet: {TRAINING_ITEM}")


def mha(q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0):
    """q: (B, Hq, S, D); k, v: (B, Hkv, Sk, D).  Flash attention."""
    return _MHA.apply(q, k, v, causal, window, q_offset)
