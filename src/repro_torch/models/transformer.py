"""GQA transformer LM: serving (prefill and decode) and training of dense
stacks.

Port of ``repro/models/transformer.py`` for one device: ``LMConfig`` and
its parameter counts, ``param_shapes``, ``init_params`` (the JAX init law),
``forward_hidden``, ``forward``, ``loss_fn``, ``prefill``, ``init_kv_cache``
and ``decode_step``, plus :func:`value_and_grad` (``jax.value_and_grad`` of
``loss_fn``).  Parameters are a plain dict laid out like the JAX pytree:
``embed`` (vocab, d), ``head`` (d, vocab), ``ln_f`` (d,) and ``blocks``, one
dict per ``block_pattern`` position whose leaves are stacked over cycles,
``(C, ...)``; :func:`params_from_numpy` carries a JAX tree across.

The JAX package scans the stacked layers and shards every intermediate; the
port loops over them on one device, taking the layers of a stacked leaf
with one ``unbind`` (whose backward stacks the layers' gradients once), and
with ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` of the scanned cycle).
RMSNorm and attention go through the backend seam (``core/backend.py``):
``kernel`` runs the ``rmsnorm_fwd`` and flash kernels, forward and backward
(their plain versions for CPU tensors), ``ref`` the plain reference path
under PyTorch autograd.  Decode attention is plain matmuls, as the JAX
package writes it (einsums, no Pallas kernel), in a grouped form that never
repeats k and v over the G query heads of a kv head.  ``decode_step``
writes the KV cache in place and returns it.  The entry points, and the
backward of :func:`value_and_grad`, run their matmuls with f32 accumulation
as XLA does (:func:`_f32_accumulation`).

MoE blocks (``models/moe.py``) and the collective matmul
(``dist/overlap.py``) raise ``NotImplementedError`` until their slices port
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backend import resolve, resolve_device
from repro_torch.core.backend import rmsnorm as _rmsnorm
from repro_torch.core.tree import leaves, tree_map
from repro_torch.core.tree import set_path as _set
from repro_torch.models.attention import mha

MOE_ITEM = "ROADMAP queue 1 item 15c (models/moe.py and the MoE configs)"
OVERLAP_ITEM = "ROADMAP queue 1 item 14 (dist/overlap.py)"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 512
    vocab: int = 1024
    block_pattern: tuple = ("dense",)
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    window: int = 0                # sliding-window attention; 0 = full
    qkv_bias: bool = False
    rope_theta: float = 1e4
    moe_groups: int = 0
    use_collective_matmul: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    aux_loss_weight: float = 0.01

    @property
    def n_cycles(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.n_layers, self.block_pattern)
        return self.n_layers // len(self.block_pattern)

    def _count(self, experts_per_token: int) -> int:
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh \
            + self.n_heads * dh * d
        dense = 3 * d * self.d_ff
        moe = d * self.n_experts + 3 * d * self.expert_d_ff * experts_per_token
        per_cycle = 0
        for kind in self.block_pattern:
            per_cycle += attn + (moe if kind == "moe" else dense) + 2 * d
        return self.n_cycles * per_cycle + 2 * self.vocab * d + d

    def n_params(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting)."""
        return self._count(self.n_experts)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        return self._count(self.top_k)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _block_param_shapes(cfg: LMConfig, kind: str) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    C = cfg.n_cycles
    p = {"ln1": (C, d), "ln2": (C, d), "wq": (C, d, hq * dh),
         "wk": (C, d, hkv * dh), "wv": (C, d, hkv * dh),
         "wo": (C, hq * dh, d)}
    if cfg.qkv_bias:
        p["bq"] = (C, hq * dh)
        p["bk"] = (C, hkv * dh)
        p["bv"] = (C, hkv * dh)
    if kind == "dense":
        p["w1"] = (C, d, cfg.d_ff)
        p["w3"] = (C, d, cfg.d_ff)
        p["w2"] = (C, cfg.d_ff, d)
    else:
        fe, e = cfg.expert_d_ff, cfg.n_experts
        p["router"] = (C, d, e)
        p["we1"] = (C, e, d, fe)
        p["we3"] = (C, e, d, fe)
        p["we2"] = (C, e, fe, d)
    return p


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree's shapes, laid out like the JAX pytree."""
    d = cfg.d_model
    return {"embed": (cfg.vocab, d), "head": (d, cfg.vocab), "ln_f": (d,),
            "blocks": [_block_param_shapes(cfg, k)
                       for k in cfg.block_pattern]}


def _empty_like_tree(cfg: LMConfig) -> dict:
    return {"blocks": [{} for _ in cfg.block_pattern]}


def init_params(cfg: LMConfig, generator: torch.Generator, *, device=None):
    """The JAX init law, with draws from ``generator`` (which must live on
    ``device``) leaf by leaf in the JAX tree's order: ones for every leaf of
    at most two axes whose last axis is d_model, else N(0, 1) in float32
    times ``fan_in ** -0.5`` (fan_in the second-to-last axis, or the last
    of a 1-D leaf), cast to ``cfg.dtype``.  The rule catches the ln scales
    and also ``embed`` (vocab, d_model): the embedding starts as all ones,
    so the model's output does not depend on the tokens (ROADMAP queue 3)."""
    dev = resolve_device(device)
    out = _empty_like_tree(cfg)
    for path, shape in leaves(param_shapes(cfg)):
        if len(shape) <= 2 and shape[-1] == cfg.d_model:
            t = torch.ones(shape, dtype=cfg.dtype, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            t = t.mul_(fan_in ** -0.5).to(cfg.dtype)
        _set(out, path, t)
    return out


def _to_torch(a, shape, dtype, dev) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"a leaf of shape {a.shape} where the config has "
                         f"{tuple(shape)}")
    if a.dtype.name == "bfloat16":          # ml_dtypes, as jax.device_get
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype, copy=True)


def params_from_numpy(cfg: LMConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays (what
    ``jax.device_get(init_params(...))`` gives), cast to ``cfg.dtype`` on
    ``device``.  Each leaf is a copy: training updates the params in
    place, and must not write into the caller's arrays."""
    dev = resolve_device(device)
    out = _empty_like_tree(cfg)
    for path, shape in leaves(param_shapes(cfg)):
        src = tree
        for key in path:
            src = src[key]
        _set(out, path, _to_torch(src, shape, cfg.dtype, dev))
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _check_supported(cfg: LMConfig) -> None:
    if cfg.use_collective_matmul:
        raise NotImplementedError(
            f"use_collective_matmul is not ported yet: {OVERLAP_ITEM}")
    for kind in cfg.block_pattern:
        if kind != "dense":
            raise NotImplementedError(
                f"{kind!r} blocks are not ported yet: {MOE_ITEM}")


def _rope(x, positions, theta: float):
    """x: (B, H, S, dh); positions: (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None, :, None].float() * freqs          # (B,1,S,h)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attn(p, cfg: LMConfig, x, positions, be, kv_cache=None, cache_pos=None):
    """x: (B, S, D).  With ``kv_cache`` ((B, Hkv, Sc, dh) views of one
    layer's cache): decode, writing the new keys and values in place."""
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, hq, dh).transpose(1, 2)
    k = k.reshape(B, S, hkv, dh).transpose(1, 2)
    v = v.reshape(B, S, hkv, dh).transpose(1, 2)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = mha(q, k, v, causal=True, window=cfg.window, backend=be)
    else:
        ck, cv = kv_cache
        Sc = ck.shape[2]
        # ring-buffer write for SWA, plain append otherwise; the start is
        # clamped so the update fits, as dynamic_update_slice does
        wpos = cache_pos % Sc if cfg.window else cache_pos
        wpos = min(max(wpos, 0), Sc - S)
        ck[:, :, wpos:wpos + S] = k.to(ck.dtype)
        cv[:, :, wpos:wpos + S] = v.to(cv.dtype)
        out = _decode_attention(q, ck, cv, cache_pos, cfg)
    out = out.transpose(1, 2).reshape(B, S, hq * dh)
    return out @ p["wo"]


def _decode_attention(q, ck, cv, cache_pos: int, cfg: LMConfig):
    """Attention of the new query rows over the whole (validity-masked)
    cache, in float32: q (B, Hq, S1, dh) against ck, cv (B, Hkv, Sc, dh),
    with the G query heads of a kv head stacked as rows, so k and v are
    read once a kv head (the JAX einsum repeats them G times)."""
    B, Hq, S1, dh = q.shape
    Hkv, Sc = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G * S1, dh)
    s = torch.matmul(qg, ck.float().transpose(-1, -2)) * dh ** -0.5
    kpos = torch.arange(Sc, device=q.device)
    if cfg.window:
        # ring buffer: valid slots are the window's most recent writes
        valid = kpos < min(cache_pos + 1, Sc)
    else:
        valid = kpos <= cache_pos
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, cv.float())
    return out.reshape(B, Hq, S1, dh).to(q.dtype)


def _ffn_dense(p, x):
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def _block(p, cfg: LMConfig, x, positions, be, kv_cache=None,
           cache_pos=None):
    h = _rmsnorm(x, p["ln1"], backend=be)
    x = x + _attn(p, cfg, h, positions, be, kv_cache, cache_pos)
    h = _rmsnorm(x, p["ln2"], backend=be)
    return x + _ffn_dense(p, h)


def _layers(params, cfg: LMConfig):
    """(cycle, pattern position, that layer's params) in execution order.
    Each stacked leaf is split once: under autograd, indexing it layer by
    layer would give every layer's gradient a zero tensor of the whole
    stack to add into."""
    per = [{n: t.unbind(0) for n, t in blk.items()}
           for blk in params["blocks"]]
    for c in range(cfg.n_cycles):
        for j in range(len(cfg.block_pattern)):
            yield c, j, {n: ts[c] for n, ts in per[j].items()}


@contextlib.contextmanager
def _f32_accumulation():
    """Matmuls that sum in f32, as XLA does: no TF32 for f32 inputs and no
    reduced-precision reduction for bf16 ones (PyTorch's default allows
    it).  The flags are process-wide, so they are restored on the way
    out."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


@_f32_accumulation()
def forward_hidden(params, cfg: LMConfig, tokens, positions=None, *,
                   backend=None):
    """Trunk only: tokens (B, S) -> hidden (B, S, D), aux (0 for dense)."""
    _check_supported(cfg)
    be = resolve(backend)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled() and \
        any(t.requires_grad for _, t in leaves(params))
    for _, _, bp in _layers(params, cfg):
        if remat:
            x = checkpoint(_block, bp, cfg, x, positions, be,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(bp, cfg, x, positions, be)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _rmsnorm(x, params["ln_f"], backend=be), aux


@_f32_accumulation()
def forward(params, cfg: LMConfig, tokens, positions=None, *, backend=None):
    """tokens (B, S) -> logits (B, S, V) float32, aux."""
    x, aux = forward_hidden(params, cfg, tokens, positions, backend=backend)
    return (x @ params["head"]).float(), aux


def loss_fn(params, cfg: LMConfig, tokens, targets, *, backend=None):
    """Mean next-token NLL over the targets >= 0 (f32 log-softmax), plus
    ``aux_loss_weight * aux``.  Returns (loss, {"nll", "aux"})."""
    logits, aux = forward(params, cfg, tokens, backend=backend)
    logp = torch.log_softmax(logits, dim=-1)
    mask = targets >= 0
    nll = -torch.gather(logp, -1, targets.clamp(min=0).long()[..., None])
    loss = torch.sum(nll[..., 0] * mask) / mask.sum().clamp(min=1)
    return loss + cfg.aux_loss_weight * aux, {"nll": loss, "aux": aux}


@_f32_accumulation()
def value_and_grad(params, cfg: LMConfig, tokens, targets, *,
                   backend=None):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), grads a tree like ``params`` in the params' dtypes.  The
    gradient is taken with respect to detached aliases of the leaves (the
    caller's tensors are not marked), and the backward, with the blocks'
    recomputation under remat, runs under the forward's f32
    accumulation."""
    tree = tree_map(lambda t: t.detach().requires_grad_(), params)
    paths, xs = zip(*leaves(tree))
    loss, metrics = loss_fn(tree, cfg, tokens, targets, backend=backend)
    grads = _empty_like_tree(cfg)
    for path, g in zip(paths, torch.autograd.grad(loss, xs)):
        _set(grads, path, g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


@_f32_accumulation()
def prefill(params, cfg: LMConfig, tokens, *, backend=None):
    """Prefill: last-token logits (B, V) float32, aux.  Only the final
    position goes through the output head."""
    x, aux = forward_hidden(params, cfg, tokens, backend=backend)
    return (x[:, -1] @ params["head"]).float(), aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_len(cfg: LMConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *,
                  device=None):
    """Cache: per pattern position, (k, v) stacked over cycles, each
    (C, batch, Hkv, Sc, dh) zeros; Sc = min(max_len, window) with SWA."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_cycles, batch, cfg.n_kv_heads, cache_len(cfg, max_len),
             cfg.d_head)
    return [tuple(torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(2)) for _ in cfg.block_pattern]


@_f32_accumulation()
def decode_step(params, cfg: LMConfig, tokens, kv_cache, cache_pos, *,
                backend=None):
    """One decode step: tokens (B, 1) at position ``cache_pos`` (the
    current length).  Writes the cache in place; returns (logits (B, V)
    float32, the cache)."""
    _check_supported(cfg)
    be = resolve(backend)
    cache_pos = int(cache_pos)
    B = tokens.shape[0]
    positions = torch.full((B, 1), cache_pos, dtype=torch.int32,
                           device=tokens.device)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for c, j, bp in _layers(params, cfg):
        ck, cv = kv_cache[j]
        x = _block(bp, cfg, x, positions, be, (ck[c], cv[c]), cache_pos)
    x = _rmsnorm(x, params["ln_f"], backend=be)
    return (x[:, 0] @ params["head"]).float(), kv_cache
