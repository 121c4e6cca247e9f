"""FlashAttention-2 forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Port of ``repro/kernels/flash_attention/kernel.py::flash_fwd``.  q is
(B*Hq, Sq, D), k and v are (B*Hkv, Sk, D) with q head h reading kv head
``h // G``; a key at position kp is live for the query at position
``qp = row + q_offset`` when ``kp <= qp`` (causal) and ``kp > qp - window``
(window > 0).  Returns ``(out, lse)``: out in q's dtype, lse (B*Hq, Sq) f32,
``out = acc / max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))`` as the
TPU kernel writes them.  Any Sq and Sk >= 1 work (the kernel masks the
ragged tails; Pallas needs multiples of its blocks), and D <= 128.
:func:`flash_fwd` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

BQ = BK = 64            # the kernel's q rows a block and keys a tile
MAX_D = 128
PLAIN_ROWS = 1024       # query rows the plain version scores at once


def kv_tiles(q0: int, rows: int, Sk: int, *, causal: bool, window: int,
             q_offset: int = 0) -> range:
    """The kv tiles (of BK keys) the kernel visits for the q block of rows
    [q0, q0 + rows): those the mask leaves live for some row.  Mirrors the
    loop bounds in the source."""
    qlo, qhi = q0 + q_offset, q0 + rows - 1 + q_offset
    kbeg = max(0, qlo - window + 1) if window > 0 else 0
    kend = min(Sk, qhi + 1) if causal else Sk
    t0 = kbeg // BK
    return range(t0, -(-kend // BK) if kend > kbeg else t0)


def flash_fwd_plain(q, k, v, *, causal: bool, window: int, scale: float,
                    q_offset: int = 0):
    """Plain PyTorch version: PLAIN_ROWS query rows at a time against every
    key (memory bounded at 32k), softmax in float32 with the kernel's
    ``max(l, 1e-30)`` and ``m + log(l)``."""
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kf = k.float()[:, None]                             # (BHkv, 1, Sk, D)
    vf = v.float()[:, None]
    qg = q.view(BHkv, G, Sq, D)
    out = torch.empty_like(q)
    lse = torch.empty((BHq, Sq), dtype=torch.float32, device=q.device)
    og, lg = out.view(BHkv, G, Sq, D), lse.view(BHkv, G, Sq)
    for a in range(0, Sq, PLAIN_ROWS):
        b = min(Sq, a + PLAIN_ROWS)
        s = torch.matmul(qg[:, :, a:b].float(), kf.transpose(-1, -2)) * scale
        msk = attention_mask(b - a, Sk, causal=causal, window=window,
                             q_offset=q_offset + a, device=q.device)
        s = torch.where(msk, s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.where(msk, torch.exp(s - m), 0.0)
        l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        og[:, :, a:b] = (torch.matmul(p, vf) / l).to(q.dtype)
        lg[:, :, a:b] = (m + torch.log(l))[..., 0]
    return out, lse


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)} must be (BHq, Sq, "
                         f"D) and k, v {tuple(k.shape)}, {tuple(v.shape)} "
                         f"(BHkv, Sk, D)")
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if BHkv < 1 or BHq % BHkv:
        raise ValueError(f"flash_fwd: BHq={BHq} is not a multiple of "
                         f"BHkv={BHkv}")
    if not 1 <= D <= MAX_D or Sk < 1:
        raise ValueError(f"flash_fwd: D={D} outside [1, {MAX_D}] or no keys "
                         f"(Sk={Sk})")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd: q, k, v must share one dtype, float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: inputs must be contiguous")


def flash_fwd(q, k, v, *, causal: bool, window: int, scale: float,
              q_offset: int = 0):
    """q: (BHq, Sq, D); k, v: (BHkv, Sk, D).  Returns (out, lse)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset)
    _cuda.require_cuda(q, k, v)
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if Sq + abs(q_offset) + Sk >= 2**31:
        raise ValueError("flash_fwd: positions must fit in int32")
    out = torch.empty_like(q)
    lse = torch.empty((BHq, Sq), dtype=torch.float32, device=q.device)
    if BHq == 0 or Sq == 0:
        return out, lse
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function("flash_fwd", "flash_fwd",
                        [p] * 5 + [i32] * 5 + [ctypes.c_float] + [i32] * 4
                        + [p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), BHq, BHq // BHkv, Sq, Sk, D, scale, int(causal),
            int(window), int(q_offset), _cuda.dtype_code(q),
            _cuda.stream_of(q))
    _cuda.check(rc, "flash_fwd")
    _cuda.LAUNCHES["flash_fwd"] += 1
    return out, lse
