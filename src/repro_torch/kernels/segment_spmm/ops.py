"""The differentiable fused gather-GEMM: the kernel's forward and the
scatter-add backward.

Port of ``repro/kernels/segment_spmm/ops.py`` (a ``jax.custom_vjp``,
differentiable with respect to x and W; ids and norm are structure).  The
forward runs the ``segment_spmm`` kernel wrapper; the backward is the JAX
package's jnp one in plain PyTorch (the TPU has no backward kernel for
it), in x's dtype: ``dW = aggregated^T @ g`` with the aggregation
recomputed, and ``dx`` the rows ``g @ W^T`` (times norm) added into every
non-padding neighbour.  Without W the JAX backward fails (it computes
``g @ w.T`` with w None); here W is then the identity and the gradient is
the natural one, ``dx`` from ``g`` itself (checked against autograd
through ``ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import f32_accumulation
from repro_torch.kernels.segment_spmm import kernel as _kernel


@f32_accumulation()
def segment_spmm_vjp(x, ids, w, norm, g):
    """(dx, dw) of ``segment_spmm(x, ids, w, norm)`` for the cotangent
    ``g``: ``repro/kernels/segment_spmm/ops.py::_bwd`` (dw None when w
    is).  JAX broadcasts to (R, K, D); here each of the K neighbour slots
    is taken in turn, so that nothing larger than (R, D) is made (the
    (R, K, D) array is 24.5 GB at ogb_products' K = 25)."""
    N, D = x.shape
    mask = ids >= 0
    dw = None
    if w is not None:
        # recompute the aggregation for dw (cheap relative to the gather)
        safe0 = torch.where(mask, ids, 0).long()
        aggregated = torch.zeros((ids.shape[0], D), dtype=x.dtype,
                                 device=x.device)
        for k in range(ids.shape[1]):
            aggregated += x[safe0[:, k]] * mask[:, k, None].to(x.dtype)
        if norm is not None:
            aggregated = aggregated * norm[:, None].to(x.dtype)
        dw = (aggregated.T @ g).to(w.dtype)
        g = g @ w.T                                       # (R, D)
    if norm is not None:
        g = g * norm[:, None].to(g.dtype)
    # padding slots add into the sink row N, which is dropped
    safe = torch.where(mask, ids, N).long()
    dx = torch.zeros((N + 1, D), dtype=g.dtype, device=g.device)
    for k in range(ids.shape[1]):
        dx.index_add_(0, safe[:, k], g)
    return dx[:N].to(x.dtype), dw


class _SegmentSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, w, norm):
        ctx.save_for_backward(x, ids, w, norm)
        return _kernel.segment_spmm(x, ids, w, norm)

    @staticmethod
    def backward(ctx, g):
        x, ids, w, norm = ctx.saved_tensors
        dx, dw = segment_spmm_vjp(x, ids, w, norm, g)
        return dx, None, dw, None


def segment_spmm(x, ids, w=None, norm=None):
    """x: (N, D); ids: (R, K) int32, -1 = padding; w: (D, Dout) or None;
    norm: (R,) or None.  Differentiable with respect to x and w."""
    return _SegmentSpmm.apply(
        x.contiguous(), ids.contiguous(),
        None if w is None else w.contiguous(),
        None if norm is None else norm.contiguous())
