"""Attention oracle in plain PyTorch (causal / sliding-window / GQA).

Port of ``repro/kernels/flash_attention/ref.py``: the whole score matrix at
once, for the tests' small shapes.
"""
import torch

NEG_INF = -1e30


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   q_offset: int = 0, device=None):
    """(sq, sk) bool mask.  ``window > 0`` keeps keys within ``window`` of the
    query (sliding-window attention); ``q_offset`` shifts query positions
    (decode, where the single query sits at position sk-1)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window and window > 0:
        m &= kpos > qpos - window
    return m


def _softmax(s):
    mx = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = torch.sum(p, dim=-1, keepdim=True)
    return p / torch.clamp(denom, min=1e-30)


def mha(q, k, v, *, causal: bool = True, window: int = 0, scale=None,
        q_offset: int = 0):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); GQA by head repetition.

    softmax(q k^T * scale + mask) v in float32; returns q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0
    g = Hq // Hkv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=1)
        v = torch.repeat_interleave(v, g, dim=1)
    scale = (D ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = attention_mask(Sq, Sk, causal=causal, window=window,
                       q_offset=q_offset, device=q.device)
    s = torch.where(m[None, None], s, NEG_INF)
    p = _softmax(s)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
