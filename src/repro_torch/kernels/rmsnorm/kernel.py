"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain
PyTorch version.

Port of ``repro/kernels/rmsnorm/kernel.py::rmsnorm_fwd``: for each row of
``x`` (..., d), ``x * rsqrt(mean(x^2) + eps) * scale`` in float32, returned
in x's dtype.  :func:`rmsnorm_fwd` runs the plain version for CPU tensors
and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda


def rmsnorm_fwd_plain(x, scale, *, eps: float = 1e-6):
    """Plain PyTorch version: the kernel's arithmetic, row by row in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _check(x, scale):
    if x.dtype not in (torch.float32, torch.bfloat16) or scale.dtype != \
            x.dtype:
        raise ValueError(f"rmsnorm_fwd: x and scale must share one dtype, "
                         f"float32 or bfloat16, got {x.dtype} and "
                         f"{scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm_fwd: scale {tuple(scale.shape)} must be "
                         f"(d,) for x {tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_fwd: inputs must be contiguous")


def rmsnorm_fwd(x, scale, *, eps: float = 1e-6):
    """x: (..., d); scale: (d,).  Returns x's shape and dtype."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_fwd_plain(x, scale, eps=eps)
    _cuda.require_cuda(x, scale)
    d = x.shape[-1]
    n = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    vec = 16 // x.element_size()
    if d % vec or any(t.data_ptr() % 16 for t in (x, scale, out)):
        vec = 1
    p = ctypes.c_void_p
    fn = _cuda.function("rmsnorm", "rmsnorm_fwd",
                        [p, p, p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float, ctypes.c_int, ctypes.c_int, p])
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
            _cuda.dtype_code(x), vec, _cuda.stream_of(x))
    _cuda.check(rc, "rmsnorm_fwd")
    _cuda.LAUNCHES["rmsnorm_fwd"] += 1
    return out
