"""The differentiable embedding-bag: the kernel's forward and the
scatter-add backward.

Port of ``repro/kernels/embedding_bag/ops.py`` (a ``jax.custom_vjp``): the
forward runs the ``embedding_bag`` kernel wrapper; the backward is the JAX
package's jnp one in plain PyTorch (the TPU has no backward kernel for
it): in mean mode the cotangent is divided by each bag's count, then it is
added into a dense (V, D) gradient at every non-padding id (padding goes
to a sentinel row V that is dropped).  No gradient flows to the ids.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import kernel as _kernel


def embedding_bag_vjp(table, ids, g, mode: str):
    """d table of ``embedding_bag(table, ids, mode)`` for the cotangent
    ``g`` (B, D): ``repro/kernels/embedding_bag/ops.py::_bwd``, a slot at
    a time (JAX broadcasts g to (B, L, D) first)."""
    (V, D), dtype = table.shape, table.dtype
    mask = ids >= 0
    if mode == "mean":
        n = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        g = g / n.to(g.dtype)
    # padding slots add into the sink row V, which is dropped
    safe = torch.where(mask, ids, V).long()
    dtable = torch.zeros((V + 1, D), dtype=g.dtype, device=g.device)
    for l in range(ids.shape[1]):
        dtable.index_add_(0, safe[:, l], g)
    return dtable[:V].to(dtype)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mode):
        ctx.save_for_backward(table, ids)
        ctx.mode = mode
        return _kernel.embedding_bag(table, ids, mode=mode)

    @staticmethod
    def backward(ctx, g):
        table, ids = ctx.saved_tensors
        return embedding_bag_vjp(table, ids, g, ctx.mode), None, None


def embedding_bag(table, ids, mode: str = "sum"):
    """table: (V, D); ids: (B, L) int32, -1 = padding.  Differentiable with
    respect to the table."""
    return _EmbeddingBag.apply(table.contiguous(), ids.contiguous(), mode)
