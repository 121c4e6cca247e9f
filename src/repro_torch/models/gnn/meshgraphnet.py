"""MeshGraphNet (arXiv:2010.03409): encode-process-decode with edge MLPs.

Port of ``repro/models/gnn/meshgraphnet.py``.  Assigned config: 15
processor blocks, d_hidden 128, sum aggregation, 2-hidden-layer MLPs with
LayerNorm (the decoder has none).  Edge features are relative positions
and their norms when ``positions`` are present, else the batch's
``edge_feat``.  Params are a dict laid out like the JAX pytree:
``enc_node``, ``enc_edge``, ``dec`` and the lists ``proc_edge``,
``proc_node``, each an MLP (``{"w": [...], "b": [...]}`` with
``ln_scale`` / ``ln_bias`` where it has a LayerNorm).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.precision import f32_accumulation
from repro_torch.core.tree import copy_from_numpy, meta_tree
from repro_torch.models.gnn.common import (GraphBatch, mlp_apply, mlp_init,
                                           mlp_shapes, scatter_dst)


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_in: int = 8
    d_edge_in: int = 4
    d_hidden: int = 128
    d_out: int = 3
    mlp_layers: int = 2
    dtype: Any = torch.float32


def _mlp_dims(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [cfg.d_hidden]


def _mlps(cfg: MGNConfig):
    """name -> (dims, layer_norm) of each MLP; the processor's as lists."""
    proc_edge = (_mlp_dims(cfg, 3 * cfg.d_hidden), True)
    proc_node = (_mlp_dims(cfg, 2 * cfg.d_hidden), True)
    return {"enc_node": (_mlp_dims(cfg, cfg.d_in), True),
            "enc_edge": (_mlp_dims(cfg, cfg.d_edge_in), True),
            "dec": ([cfg.d_hidden] * (cfg.mlp_layers + 1) + [cfg.d_out],
                    False),
            "proc_edge": [proc_edge] * cfg.n_layers,
            "proc_node": [proc_node] * cfg.n_layers}


def param_shapes(cfg: MGNConfig) -> dict:
    return {k: ([mlp_shapes(*m) for m in v] if isinstance(v, list)
                else mlp_shapes(*v)) for k, v in _mlps(cfg).items()}


def param_shape_dtypes(cfg: MGNConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry run's shapes)."""
    return meta_tree(param_shapes(cfg), cfg.dtype)


def init_params(cfg: MGNConfig, generator: torch.Generator, *, device=None):
    """Weights N(0, 1/fan_in) from ``generator`` (the JAX law, other
    numbers), biases 0, LayerNorm scale 1 and bias 0."""
    dev = resolve_device(device)

    def mlp(dims, layer_norm):
        return mlp_init(generator, dims, dtype=cfg.dtype,
                        layer_norm=layer_norm, device=dev)
    return {k: ([mlp(*m) for m in v] if isinstance(v, list) else mlp(*v))
            for k, v in _mlps(cfg).items()}


def params_from_numpy(cfg: MGNConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays, cast
    to ``cfg.dtype`` on ``device``; every leaf a copy."""
    return copy_from_numpy(param_shapes(cfg), tree, cfg.dtype,
                           resolve_device(device))


def _edge_inputs(cfg: MGNConfig, batch: GraphBatch):
    if batch.edge_feat is not None:
        return batch.edge_feat.to(cfg.dtype)
    assert batch.positions is not None
    ok = batch.edge_src >= 0
    src = torch.where(ok, batch.edge_src, 0).long()
    dst = torch.where(ok, batch.edge_dst, 0).long()
    rel = batch.positions[dst] - batch.positions[src]
    feat = torch.cat([rel, torch.linalg.vector_norm(rel, dim=-1,
                                                    keepdim=True)], dim=-1)
    return (feat * ok[:, None]).to(cfg.dtype)


@f32_accumulation()
def forward(params, cfg: MGNConfig, batch: GraphBatch):
    n = batch.node_feat.shape[0]
    ok = (batch.edge_src >= 0)[:, None].to(cfg.dtype)
    v = mlp_apply(params["enc_node"], batch.node_feat.to(cfg.dtype))
    e = mlp_apply(params["enc_edge"], _edge_inputs(cfg, batch))
    src = torch.where(batch.edge_src >= 0, batch.edge_src, 0).long()
    dst = torch.where(batch.edge_src >= 0, batch.edge_dst, 0).long()
    for pe, pn in zip(params["proc_edge"], params["proc_node"]):
        e_in = torch.cat([e, v[src], v[dst]], dim=-1)
        e = e + mlp_apply(pe, e_in) * ok
        agg = scatter_dst(e, batch, n)
        v = v + mlp_apply(pn, torch.cat([v, agg], dim=-1))
    return mlp_apply(params["dec"], v)


def loss_fn(params, cfg: MGNConfig, batch: GraphBatch):
    pred = forward(params, cfg, batch).float()
    target = batch.labels.float()
    mask = batch.train_mask[:, None].float()
    mse = torch.sum(((pred - target) ** 2) * mask) / torch.clamp(mask.sum(),
                                                                 min=1)
    return mse, {"mse": mse}
