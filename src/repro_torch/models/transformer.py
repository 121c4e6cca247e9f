"""GQA transformer LM: serving (prefill and decode) and training of dense
and MoE stacks.

Port of ``repro/models/transformer.py`` for one device: ``LMConfig`` and
its parameter counts, ``param_shapes``, ``init_params`` (the JAX init law),
``forward_hidden``, ``forward``, ``loss_fn``, ``prefill``, ``init_kv_cache``
and ``decode_step``, the dry run's ``param_shape_dtypes``, ``logical_axes``
and ``kv_cache_shape_dtypes`` (``meta`` tensors), plus
:func:`value_and_grad` (``jax.value_and_grad`` of ``loss_fn``).  Parameters are a plain dict laid out like the JAX pytree:
``embed`` (vocab, d), ``head`` (d, vocab), ``ln_f`` (d,) and ``blocks``, one
dict per ``block_pattern`` position whose leaves are stacked over cycles,
``(C, ...)``; :func:`params_from_numpy` carries a JAX tree across.  A
``"moe"`` block runs ``models/moe.py::moe_ffn`` over its B * S tokens in
place of the dense SwiGLU, and the blocks' load-balance losses sum into
the ``aux`` that ``forward`` returns and ``loss_fn`` weighs in.

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
as XLA does (:func:`_f32_accumulation`).  With
``use_collective_matmul`` the q/k/v and w1/w3 products run the ring matmul
of ``dist/overlap.py::tp_matmul_ag`` over the mesh in scope (the plain
product where there is none), and ``constrain`` (``dist/sharding.py``)
marks the JAX package's sharding points.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backend import resolve, resolve_device
from repro_torch.core.backend import rmsnorm as _rmsnorm
from repro_torch.core.precision import f32_accumulation as _f32_accumulation
from repro_torch.core.tree import copy_from_numpy, leaves, meta_tree, tree_map
from repro_torch.core.tree import value_and_grad as tree_value_and_grad
from repro_torch.core.tree import set_path as _set
from repro_torch.dist.overlap import tp_matmul_ag
from repro_torch.dist.sharding import constrain
from repro_torch.models.attention import mha
from repro_torch.models.moe import moe_ffn

_DRAW = 1 << 28      # init_params' float32 draws: 1 GiB at most


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


# each parameter's logical sharding axes (dist/sharding.py), by leaf name
_AXES = {
    "embed": ("vocab", "fsdp"), "head": ("fsdp", "vocab"),
    "ln_f": ("embed",),
    "ln1": ("layers", "embed"), "ln2": ("layers", "embed"),
    "wq": ("layers", "fsdp", "heads"), "wk": ("layers", "fsdp", "heads"),
    "wv": ("layers", "fsdp", "heads"), "wo": ("layers", "heads", "fsdp"),
    "bq": ("layers", "heads"), "bk": ("layers", "heads"),
    "bv": ("layers", "heads"),
    "w1": ("layers", "fsdp", "ff"), "w3": ("layers", "fsdp", "ff"),
    "w2": ("layers", "ff", "fsdp"),
    "router": ("layers", "embed", None),
    "we1": ("layers", "expert", "fsdp", None),
    "we3": ("layers", "expert", "fsdp", None),
    "we2": ("layers", "expert", None, "fsdp"),
}


def logical_axes(cfg: LMConfig) -> dict:
    """Each parameter's logical axes, in a tree laid out like the params
    (the second half of the JAX ``param_shapes``)."""
    out = tree_map(lambda s: None, param_shapes(cfg))
    for path, _ in leaves(param_shapes(cfg)):
        _set(out, path, _AXES[path[-1]])
    return out


def param_shape_dtypes(cfg: LMConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry run's shapes: no
    allocation)."""
    return meta_tree(param_shapes(cfg), cfg.dtype)


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
            t = torch.empty(shape, dtype=cfg.dtype, device=dev)
            flat = t.view(-1)
            for a in range(0, flat.numel(), _DRAW):
                part = flat[a:a + _DRAW]
                part.copy_(torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32, device=dev)
                           .mul_(fan_in ** -0.5))
        _set(out, path, t)
    return out


def params_from_numpy(cfg: LMConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays (what
    ``jax.device_get(init_params(...))`` gives), cast to ``cfg.dtype`` on
    ``device``.  Each leaf is a copy: training updates the params in
    place, and must not write into the caller's arrays."""
    return copy_from_numpy(param_shapes(cfg), tree, cfg.dtype,
                           resolve_device(device))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

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
    mm = _mm(cfg)
    q, k, v = mm(x, p["wq"]), mm(x, p["wk"]), mm(x, p["wv"])
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
        ck = constrain(ck, ("batch", None, "kv_seq", None))
        cv = constrain(cv, ("batch", None, "kv_seq", None))
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


def _mm(cfg: LMConfig):
    return tp_matmul_ag if cfg.use_collective_matmul else torch.matmul


def _ffn_dense(p, x, cfg: LMConfig):
    mm = _mm(cfg)
    return (F.silu(mm(x, p["w1"])) * mm(x, p["w3"])) @ p["w2"]


def _block(p, cfg: LMConfig, kind: str, x, positions, be, kv_cache=None,
           cache_pos=None):
    """One layer: (x, aux), aux the MoE block's load-balance loss (a
    float32 0 for a dense block)."""
    B, S, D = x.shape
    h = _rmsnorm(x, p["ln1"], backend=be)
    x = x + _attn(p, cfg, h, positions, be, kv_cache, cache_pos)
    h = _rmsnorm(x, p["ln2"], backend=be)
    if kind == "dense":
        x = x + _ffn_dense(p, h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        y, moe_aux = moe_ffn(h.reshape(B * S, D), p["router"], p["we1"],
                             p["we3"], p["we2"], top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             groups=cfg.moe_groups)
        x = x + y.reshape(B, S, D)
        aux = moe_aux["aux_loss"]
    return constrain(x, ("batch", "seq", None)), aux


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


@_f32_accumulation()
def forward_hidden(params, cfg: LMConfig, tokens, positions=None, *,
                   backend=None):
    """Trunk only: tokens (B, S) -> hidden (B, S, D), aux (the MoE blocks'
    load-balance losses summed; 0 for a dense stack)."""
    be = resolve(backend)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    x = constrain(x, ("batch", "seq", None))
    remat = cfg.remat and torch.is_grad_enabled() and \
        any(t.requires_grad for _, t in leaves(params))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, j, bp in _layers(params, cfg):
        kind = cfg.block_pattern[j]
        if remat:
            x, a = checkpoint(_block, bp, cfg, kind, x, positions, be,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _block(bp, cfg, kind, x, positions, be)
        aux = aux + a
    return _rmsnorm(x, params["ln_f"], backend=be), aux


@_f32_accumulation()
def forward(params, cfg: LMConfig, tokens, positions=None, *, backend=None):
    """tokens (B, S) -> logits (B, S, V) float32, aux."""
    x, aux = forward_hidden(params, cfg, tokens, positions, backend=backend)
    logits = (x @ params["head"]).float()
    return constrain(logits, ("batch", "seq", "vocab")), aux


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
    return tree_value_and_grad(loss_fn, params, cfg, tokens, targets,
                               backend=backend)


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


def kv_cache_shape_dtypes(cfg: LMConfig, batch: int, max_len: int,
                          dtype=None):
    """The KV cache as ``meta`` tensors (the dry run's shapes)."""
    return init_kv_cache(cfg, batch, max_len, dtype, device="meta")


@_f32_accumulation()
def decode_step(params, cfg: LMConfig, tokens, kv_cache, cache_pos, *,
                backend=None):
    """One decode step: tokens (B, 1) at position ``cache_pos`` (the
    current length).  Writes the cache in place; returns (logits (B, V)
    float32, the cache)."""
    be = resolve(backend)
    cache_pos = int(cache_pos)
    B = tokens.shape[0]
    positions = torch.full((B, 1), cache_pos, dtype=torch.int32,
                           device=tokens.device)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for c, j, bp in _layers(params, cfg):
        ck, cv = kv_cache[j]
        x, _ = _block(bp, cfg, cfg.block_pattern[j], x, positions, be,
                      (ck[c], cv[c]), cache_pos)
    x = _rmsnorm(x, params["ln_f"], backend=be)
    return (x[:, 0] @ params["head"]).float(), kv_cache
