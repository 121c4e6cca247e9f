"""The RMSNorm op of the model: the kernel's forward and the analytic VJP.

Port of ``repro/kernels/rmsnorm/ops.py::rmsnorm`` (a ``jax.custom_vjp``):
the forward runs the ``rmsnorm_fwd`` kernel wrapper and keeps x and scale;
the backward is the JAX package's analytic one (jnp there, plain PyTorch
here: the TPU has no backward kernel for it), in float32, with ``dscale``
summed over every leading axis and each gradient returned in its input's
dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel as _kernel


def rmsnorm_vjp(x, scale, g, eps: float):
    """(dx, dscale) of ``x * rsqrt(mean(x^2) + eps) * scale`` for the
    cotangent ``g``: ``repro/kernels/rmsnorm/ops.py::_bwd``."""
    xf, gf, sf = x.float(), g.float(), scale.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gs = gf * sf
    dx = r * (gs - xhat * torch.mean(gs * xhat, dim=-1, keepdim=True))
    dscale = torch.sum(gf * xhat, dim=tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _kernel.rmsnorm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*rmsnorm_vjp(x, scale, g, ctx.eps), None)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  The kernel's forward on any shape."""
    return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps)
