"""ELL fused gather-GEMM (GNN message passing): the CUDA kernel
``csrc/segment_spmm.cu`` and its plain PyTorch version.

Port of ``repro/kernels/segment_spmm/kernel.py::segment_spmm``: for each
row r of ids (R, K), ``acc = sum_k x[ids[r, k]]`` over k = 0..K-1 in order,
in float32, ids < 0 (padding) adding nothing; then ``acc * norm[r]`` (norm
in f32) if norm is given, then ``acc @ W`` in f32 if W (D, Dout) is given;
the result in x's dtype (float32 or bfloat16; W shares it).
:func:`segment_spmm` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors.  Ids must be below N; the kernel skips any
that are not, the plain version raises on them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import f32_accumulation
from repro_torch.kernels import _cuda

MAX_D = 8192            # the kernel's row tile holds at least one row of D


def segment_spmm_plain(x, ids, w=None, norm=None):
    """Plain PyTorch version: the kernel's arithmetic, one neighbour at a
    time in order, in f32, and the W product in f32 (no TF32)."""
    _check(x, ids, w, norm)
    R, K = ids.shape
    acc = torch.zeros((R, x.shape[1]), dtype=torch.float32, device=x.device)
    mask = ids >= 0
    safe = torch.where(mask, ids, 0).long()
    for k in range(K):
        acc += torch.where(mask[:, k, None], x[safe[:, k]].float(), 0.0)
    if norm is not None:
        acc = acc * norm.float()[:, None]
    if w is not None:
        with f32_accumulation():
            acc = acc @ w.float()
    return acc.to(x.dtype)


def _check(x, ids, w, norm):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segment_spmm: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"segment_spmm: ids must be int32, got {ids.dtype}")
    if x.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"segment_spmm: x {tuple(x.shape)} must be (N, D) "
                         f"and ids {tuple(ids.shape)} (R, K)")
    if w is not None and (w.dtype != x.dtype or w.dim() != 2
                          or w.shape[0] != x.shape[1]):
        raise ValueError(f"segment_spmm: w {tuple(w.shape)} {w.dtype} must "
                         f"be (D, Dout) in x's dtype {x.dtype}, D = "
                         f"{x.shape[1]}")
    if norm is not None and tuple(norm.shape) != (ids.shape[0],):
        raise ValueError(f"segment_spmm: norm {tuple(norm.shape)} must be "
                         f"(R,) = ({ids.shape[0]},)")
    if not all(t.is_contiguous() for t in (x, ids, w, norm)
               if t is not None):
        raise ValueError("segment_spmm: inputs must be contiguous")


def segment_spmm(x, ids, w=None, norm=None):
    """x: (N, D); ids: (R, K) int32, -1 = padding; w: (D, Dout) or None;
    norm: (R,) or None.  Returns (R, Dout or D) in x's dtype."""
    _check(x, ids, w, norm)
    if x.device.type == "cpu":
        return segment_spmm_plain(x, ids, w, norm)
    norm_f = None if norm is None else norm.float().contiguous()
    _cuda.require_cuda(*(t for t in (x, ids, w, norm_f) if t is not None))
    (N, D), (R, K) = x.shape, ids.shape
    if D > MAX_D:
        raise ValueError(f"segment_spmm: D = {D} is above the kernel's "
                         f"{MAX_D}")
    d_out = D if w is None else w.shape[1]
    out = torch.empty((R, d_out), dtype=x.dtype, device=x.device)
    if R == 0 or d_out == 0:
        return out
    if D == 0:                  # an empty sum times W
        return out.zero_()
    p = ctypes.c_void_p
    fn = _cuda.function("segment_spmm", "segment_spmm",
                        [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, p])
    rc = fn(x.data_ptr(), ids.data_ptr(),
            None if w is None else w.data_ptr(),
            None if norm_f is None else norm_f.data_ptr(), out.data_ptr(),
            N, D, R, K, d_out, _cuda.dtype_code(x), _cuda.stream_of(x))
    _cuda.check(rc, "segment_spmm")
    _cuda.LAUNCHES["segment_spmm"] += 1
    return out
