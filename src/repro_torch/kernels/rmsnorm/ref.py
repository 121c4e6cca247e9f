"""RMSNorm in plain PyTorch (the ``ref`` backend).

Port of ``repro/kernels/rmsnorm/ref.py``.
"""
import torch


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """y = x / rms(x) * scale, reduced over the last axis in float32 and
    returned in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * scale.float()).to(x.dtype)
