"""BST: Behavior Sequence Transformer (Alibaba, arXiv:1905.06874).

Port of ``repro/models/recsys.py``.  Assigned config: embed_dim 32,
behavior seq_len 20, 1 transformer block, 8 heads, MLP 1024-512-256.
Params are a dict laid out like the JAX pytree, with the JAX package's
logical sharding axes (:func:`logical_axes`: the item table, 10^6-10^9
rows, is row-sharded over the mesh) and its ``constrain`` point
(``dist/sharding.py``); one card holds every tensor whole.  The table's
gradient is dense (V, D), as in JAX.

  train_batch     (B=65536)  CTR training step (BCE)
  serve_p99       (B=512)    online scoring
  serve_bulk      (B=262144) offline scoring
  retrieval_cand  (B=1, 1M candidates) one user tower output dotted
                  against a million candidate item embeddings
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.backend import resolve_device
from repro_torch.core.precision import f32_accumulation
from repro_torch.core.tree import (copy_from_numpy, leaves, meta_tree,
                                   set_path, tree_map)
from repro_torch.dist.sharding import constrain
from repro_torch.models.embedding import gspmd_lookup


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 1_000_000
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    d_ff: int = 128
    mlp_dims: tuple = (1024, 512, 256)
    n_dense: int = 8
    dtype: Any = torch.float32


def param_shapes(cfg: BSTConfig) -> dict:
    """The parameter tree's shapes, laid out like the JAX pytree (the JAX
    function also returns each leaf's logical axes: :func:`logical_axes`)."""
    d = cfg.embed_dim
    dims = ((cfg.seq_len + 2) * d,) + tuple(cfg.mlp_dims) + (1,)
    return {
        "item_emb": (cfg.n_items, d),
        "pos_emb": (cfg.seq_len + 1, d),
        "dense_proj": (cfg.n_dense, d),
        "blocks": [{"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                    "ln1": (d,), "ln2": (d,), "w1": (d, cfg.d_ff),
                    "w2": (cfg.d_ff, d)} for _ in range(cfg.n_blocks)],
        "mlp_w": [(a, b) for a, b in zip(dims[:-1], dims[1:])],
        "mlp_b": [(b,) for b in dims[1:]],
    }


def init_params(cfg: BSTConfig, generator: torch.Generator, *, device=None):
    """The JAX init law, with draws from ``generator`` (which must live on
    ``device``) leaf by leaf in the JAX tree's order: a 1-D leaf of length
    ``embed_dim`` is ones, any other 1-D leaf zeros, every other leaf N(0,
    1) in float32 times ``shape[0] ** -0.5``, cast to ``cfg.dtype``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    out = tree_map(lambda s: None, shapes)
    for path, s in leaves(shapes):
        if len(s) == 1:
            t = (torch.ones if s[0] == cfg.embed_dim else torch.zeros)(
                s, dtype=cfg.dtype, device=dev)
        else:
            t = torch.randn(s, generator=generator, dtype=torch.float32,
                            device=dev).mul_(s[0] ** -0.5).to(cfg.dtype)
        set_path(out, path, t)
    return out


def params_from_numpy(cfg: BSTConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays, cast
    to ``cfg.dtype`` on ``device``; every leaf a copy."""
    return copy_from_numpy(param_shapes(cfg), tree, cfg.dtype,
                           resolve_device(device))


_AXES = {"item_emb": ("storage", None), "pos_emb": (None, None),
         "dense_proj": (None, None), "wq": (None, "tensor"),
         "wk": (None, "tensor"), "wv": (None, "tensor"),
         "wo": ("tensor", None), "ln1": (None,), "ln2": (None,),
         "w1": (None, "tensor"), "w2": ("tensor", None)}


def logical_axes(cfg: BSTConfig) -> dict:
    """Each parameter's logical axes, laid out like the params; an MLP
    layer's output dim shards on "tensor" only from 128 columns up."""
    shapes = param_shapes(cfg)
    out = tree_map(lambda s: None, shapes)
    for path, shape in leaves(shapes):
        if path[0] == "mlp_w":
            axes = ("fsdp", "tensor" if shape[1] >= 128 else None)
        elif path[0] == "mlp_b":
            axes = (None,)
        else:
            axes = _AXES[path[-1]]
        set_path(out, path, axes)
    return out


def param_shape_dtypes(cfg: BSTConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry run's shapes)."""
    return meta_tree(param_shapes(cfg), cfg.dtype)


def _ln(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _block(p, cfg: BSTConfig, x):
    """Post-norm transformer block over the (L+1) behavior sequence."""
    B, L, d = x.shape
    h = cfg.n_heads
    dh = d // h

    def heads(y):
        return y.reshape(B, L, h, dh).transpose(1, 2)
    q, k, v = heads(x @ p["wq"]), heads(x @ p["wk"]), heads(x @ p["wv"])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * dh ** -0.5
    a = torch.softmax(s.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", a, v)
    o = o.transpose(1, 2).reshape(B, L, d) @ p["wo"]
    x = _ln(x + o, p["ln1"])
    f = F.relu(x @ p["w1"]) @ p["w2"]          # leaky-relu in paper
    return _ln(x + f, p["ln2"])


@f32_accumulation()
def forward(params, cfg: BSTConfig, hist_ids, target_ids, dense):
    """hist_ids (B, L), target_ids (B,), dense (B, n_dense) -> logits (B,)."""
    B, L = hist_ids.shape
    seq = torch.cat([hist_ids, target_ids[:, None]], dim=1)
    emb = gspmd_lookup(params["item_emb"], seq).to(cfg.dtype)
    emb = emb + params["pos_emb"][None, :, :]
    emb = constrain(emb, ("batch", None, None))
    for bp in params["blocks"]:
        emb = _block(bp, cfg, emb)
    other = dense.to(cfg.dtype) @ params["dense_proj"]
    x = torch.cat([emb.reshape(B, -1), other], dim=-1)
    n = len(params["mlp_w"])
    for i, (w, b) in enumerate(zip(params["mlp_w"], params["mlp_b"])):
        x = x @ w + b
        if i < n - 1:
            x = F.leaky_relu(x)
    return x[:, 0].float()


def loss_fn(params, cfg: BSTConfig, hist_ids, target_ids, dense, labels):
    logits = forward(params, cfg, hist_ids, target_ids, dense)
    bce = torch.mean(torch.clamp(logits, min=0) - logits * labels
                     + torch.log1p(torch.exp(-torch.abs(logits))))
    return bce, {"bce": bce}


@f32_accumulation()
def user_tower(params, cfg: BSTConfig, hist_ids, dense):
    """Retrieval: encode the user history into one d-dim vector."""
    B, L = hist_ids.shape
    emb = gspmd_lookup(params["item_emb"], hist_ids).to(cfg.dtype)
    emb = emb + params["pos_emb"][None, :L, :]
    for bp in params["blocks"]:
        emb = _block(bp, cfg, emb)
    return emb.mean(dim=1) + dense.to(cfg.dtype) @ params["dense_proj"]


@f32_accumulation()
def retrieval_scores(params, cfg: BSTConfig, hist_ids, dense, cand_ids):
    """Score users against a large candidate set: cand_ids (C,) -> scores
    (B, C) = user_vec @ cand_emb^T, one matmul over the gathered rows."""
    u = user_tower(params, cfg, hist_ids, dense)              # (B, d)
    ce = gspmd_lookup(params["item_emb"], cand_ids)           # (C, d)
    return (u @ ce.T.to(u.dtype)).float()
