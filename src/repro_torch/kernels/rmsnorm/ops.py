"""The RMSNorm op of the model: the kernel wrapper, forward only.

Port of ``repro/kernels/rmsnorm/ops.py::rmsnorm`` for serving.  The JAX op
has a custom VJP (the analytic backward); this slice serves, so the op is a
``torch.autograd.Function`` whose backward raises until the training slice
(ROADMAP queue 1 item 15b) ports it: no gradient comes silently from plain
PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel as _kernel

TRAINING_ITEM = "ROADMAP queue 1 item 15b (LM training)"


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        return _kernel.rmsnorm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"the rmsnorm backward is not ported yet: {TRAINING_ITEM}")


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  The kernel's forward on any shape."""
    return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps)
