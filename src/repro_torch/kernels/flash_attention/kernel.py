"""FlashAttention-2, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and their plain PyTorch
versions.

Port of ``repro/kernels/flash_attention/kernel.py`` (``flash_fwd`` and the
two kernels of ``flash_bwd``).  q is (B*Hq, Sq, D), k and v are (B*Hkv, Sk,
D) with q head h reading kv head ``h // G``; a key at position kp is live
for the query at position ``qp = row + q_offset`` when ``kp <= qp``
(causal) and ``kp > qp - window`` (window > 0).  The forward returns
``(out, lse)``: out in q's dtype, lse (B*Hq, Sq) f32, ``out = acc /
max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))`` as the TPU kernel
writes them.  The backward takes the forward's lse and ``delta = sum(out *
dout, -1)`` (f32, computed by the caller as the JAX package computes it
outside its kernels) and returns dq (``flash_bwd_dq``) and dk, dv
(``flash_bwd_dkv``) in the inputs' dtype, with ``p = exp(s - lse)`` on live
pairs and ``ds = p * (dp - delta) * scale``.  Any Sq and Sk >= 1 work (the
kernels mask the ragged tails; Pallas needs multiples of its blocks), and
D <= 128.  Each wrapper runs its plain version for CPU tensors and launches
its kernel for CUDA tensors.  On the card the route is chosen by dtype
alone: bf16 inputs run the tensor-core kernels (``flash_fwd_tc_kernel``,
``flash_bwd_dkv_tc_kernel``, ``flash_bwd_dq_tc_kernel``), float32 the
CUDA-core ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

BQ = BK = 64            # the CUDA-core kernels' q rows a block, keys a tile
# the tensor-core kernels (bf16): flash_fwd_tc_kernel's q rows a block, keys
# a tile and q rows a warp; flash_bwd_dkv_tc_kernel's keys a block, q rows a
# tile and keys a warp; flash_bwd_dq_tc_kernel's q rows a block, keys a tile
# and q rows a warp
TC_BQ, TC_BK, TC_WARP_ROWS = 128, 64, 32
DKV_BK, DKV_BQ, DKV_WARP_KEYS = 64, 64, 16
DQ_BQ, DQ_BK, DQ_WARP_ROWS = 64, 64, 16
SKIP, MASKED, FULL = 0, 1, 2    # tile_class
MAX_D = 128
PLAIN_ROWS = 1024       # query rows the plain version scores at once


def kv_tiles(q0: int, rows: int, Sk: int, *, causal: bool, window: int,
             q_offset: int = 0, bk: int = BK) -> range:
    """The kv tiles (of ``bk`` keys) a kernel visits for the q block of rows
    [q0, q0 + rows): those the mask leaves live for some row.  Mirrors the
    loop bounds in the sources (flash_fwd's two kernels, flash_bwd_dq)."""
    qlo, qhi = q0 + q_offset, q0 + rows - 1 + q_offset
    kbeg = max(0, qlo - window + 1) if window > 0 else 0
    kend = min(Sk, qhi + 1) if causal else Sk
    t0 = kbeg // bk
    return range(t0, -(-kend // bk) if kend > kbeg else t0)


def q_tiles(k0: int, cols: int, Sq: int, *, causal: bool, window: int,
            q_offset: int = 0, bq: int = BQ) -> range:
    """The q tiles (of ``bq`` rows) a dK/dV kernel visits for the k tile of
    keys [k0, k0 + cols): those holding a row that the mask lets see one of
    its keys (``qp >= k0`` causal, ``qp < k0 + cols - 1 + window`` under a
    window).  Mirrors the loop bounds in the source."""
    rbeg = max(0, k0 - q_offset) if causal else 0
    rend = min(Sq, k0 + cols - 1 + window - q_offset) if window > 0 else Sq
    t0 = rbeg // bq
    return range(t0, -(-rend // bq) if rend > rbeg else t0)


def tile_class(q0: int, rows: int, Sq: int, k0: int, cols: int, Sk: int, *,
               causal: bool, window: int, q_offset: int = 0) -> int:
    """The mask over query rows [q0, q0 + rows) and keys [k0, k0 + cols), as
    a tensor-core kernel's warp sees it: SKIP (no live pair), FULL (every
    row and key inside [0, Sq) x [0, Sk) and every pair live: no mask test)
    or MASKED.  Mirrors ``tile_class`` in ``csrc/flash_mma.cuh``."""
    nq, nk = min(rows, Sq - q0), min(cols, Sk - k0)
    if nq <= 0 or nk <= 0:
        return SKIP
    qlo, qhi = q0 + q_offset, q0 + nq - 1 + q_offset
    k1 = k0 + nk - 1
    if (causal and k0 > qhi) or (window > 0 and k1 <= qlo - window):
        return SKIP
    if nq == rows and nk == cols and (not causal or k1 <= qlo) and \
            (window <= 0 or k0 > qhi - window):
        return FULL
    return MASKED


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


def _check(q, k, v, what="flash_fwd"):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            q.shape[2] != k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be (BHq, Sq, "
                         f"D) and k, v {tuple(k.shape)}, {tuple(v.shape)} "
                         f"(BHkv, Sk, D)")
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if BHkv < 1 or BHq % BHkv:
        raise ValueError(f"{what}: BHq={BHq} is not a multiple of "
                         f"BHkv={BHkv}")
    if not 1 <= D <= MAX_D or Sk < 1:
        raise ValueError(f"{what}: D={D} outside [1, {MAX_D}] or no keys "
                         f"(Sk={Sk})")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share one dtype, float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")


def _check_positions(q, k, window, q_offset, what):
    if q.shape[1] + k.shape[1] + abs(q_offset) + max(window, 0) >= 2**31:
        raise ValueError(f"{what}: positions must fit in int32")


def flash_fwd(q, k, v, *, causal: bool, window: int, scale: float,
              q_offset: int = 0):
    """q: (BHq, Sq, D); k, v: (BHkv, Sk, D).  Returns (out, lse)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset)
    _cuda.require_cuda(q, k, v)
    _check_positions(q, k, window, q_offset, "flash_fwd")
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd_plain(q, k, v, do, lse, delta, *, causal, window, scale, q_offset,
               want_dq, want_dkv):
    """The backward's arithmetic in plain PyTorch, PLAIN_ROWS query rows at
    a time against every key with the G q heads of a kv head stacked, in
    float32: dq for the rows of each pass, dk and dv summed over passes and
    heads."""
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    G = BHq // BHkv
    kf = k.float()[:, None]                             # (BHkv, 1, Sk, D)
    vf = v.float()[:, None]
    qg, og = q.view(BHkv, G, Sq, D), do.view(BHkv, G, Sq, D)
    lg, dg = lse.view(BHkv, G, Sq, 1), delta.view(BHkv, G, Sq, 1)
    dq = torch.empty_like(q) if want_dq else None
    dk = torch.zeros((BHkv, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for a in range(0, Sq, PLAIN_ROWS):
        b = min(Sq, a + PLAIN_ROWS)
        qa, oa = qg[:, :, a:b].float(), og[:, :, a:b].float()
        s = torch.matmul(qa, kf.transpose(-1, -2)) * scale
        msk = attention_mask(b - a, Sk, causal=causal, window=window,
                             q_offset=q_offset + a, device=q.device)
        p = torch.where(msk, torch.exp(s - lg[:, :, a:b]), 0.0)
        ds = p * (torch.matmul(oa, vf.transpose(-1, -2)) - dg[:, :, a:b]) \
            * scale
        if want_dkv:
            dv += torch.matmul(p.transpose(-1, -2), oa).sum(1)
            dk += torch.matmul(ds.transpose(-1, -2), qa).sum(1)
        if want_dq:
            dq.view(BHkv, G, Sq, D)[:, :, a:b] = \
                torch.matmul(ds, kf).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, do, lse, delta, *, causal: bool, window: int,
                    scale: float, q_offset: int = 0):
    """Plain PyTorch version of both kernels: (dq, dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, delta, causal=causal, window=window,
                      scale=scale, q_offset=q_offset, want_dq=True,
                      want_dkv=True)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                        window: int, scale: float, q_offset: int = 0):
    """Plain PyTorch version of the dK/dV kernel: (dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, delta, causal=causal, window=window,
                      scale=scale, q_offset=q_offset, want_dq=False,
                      want_dkv=True)[1:]


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                       window: int, scale: float, q_offset: int = 0):
    """Plain PyTorch version of the dQ kernel: dq."""
    return _bwd_plain(q, k, v, do, lse, delta, causal=causal, window=window,
                      scale=scale, q_offset=q_offset, want_dq=True,
                      want_dkv=False)[0]


def _check_bwd(q, k, v, do, lse, delta, what):
    _check(q, k, v, what)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"{what}: dout {tuple(do.shape)} {do.dtype} must "
                         f"be contiguous and like q {tuple(q.shape)} "
                         f"{q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} "
                             f"must be contiguous float32 "
                             f"{tuple(q.shape[:2])}")


def _launch_bwd(symbol, q, k, v, do, lse, delta, outs, rows, *, causal,
                window, scale, q_offset):
    _cuda.require_cuda(q, k, v, do, lse, delta)
    _check_positions(q, k, window, q_offset, symbol)
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function("flash_bwd", symbol,
                        [p] * (6 + len(outs)) + [i32] * 5 + [ctypes.c_float]
                        + [i32] * 4 + [p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            rows, BHq // BHkv, Sq, Sk, D, scale, int(causal), int(window),
            int(q_offset), _cuda.dtype_code(q), _cuda.stream_of(q))
    _cuda.check(rc, symbol)
    _cuda.LAUNCHES[symbol] += 1


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, window: int,
                  scale: float, q_offset: int = 0):
    """dk, dv (like k and v) from q, k, v, dout (like q), the forward's lse
    and delta (B*Hq, Sq) float32."""
    _check_bwd(q, k, v, do, lse, delta, "flash_bwd_dkv")
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv),
                k.shape[0], **kw)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, window: int,
                 scale: float, q_offset: int = 0):
    """dq (like q) from the same inputs as :func:`flash_bwd_dkv`."""
    _check_bwd(q, k, v, do, lse, delta, "flash_bwd_dq")
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dq = torch.empty_like(q)
    if q.shape[0] and q.shape[1]:
        _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
                    q.shape[0], **kw)
    return dq


def flash_bwd(q, k, v, do, lse, delta, *, causal: bool, window: int,
              scale: float, q_offset: int = 0):
    """The backward: (dq, dk, dv), one launch of each kernel; on CPU
    tensors one pass of the plain version."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        _check_bwd(q, k, v, do, lse, delta, "flash_bwd")
        return flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
