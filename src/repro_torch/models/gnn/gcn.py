"""GCN (Kipf & Welling, arXiv:1609.02907): sym-normalized SpMM layers.

Port of ``repro/models/gnn/gcn.py``.  gcn-cora assigned config: 2 layers,
d_hidden 16, sym aggregation.  Params are a dict laid out like the JAX
pytree: ``{"w": [(a, b)...], "b": [(b,)...]}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.backend import resolve_device
from repro_torch.core.precision import f32_accumulation
from repro_torch.core.tree import copy_from_numpy, meta_tree
from repro_torch.models.gnn.common import GraphBatch, node_loss, spmm


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"
    dtype: Any = torch.float32


def _dims(cfg: GCNConfig):
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


def param_shapes(cfg: GCNConfig) -> dict:
    dims = _dims(cfg)
    return {"w": [(a, b) for a, b in zip(dims[:-1], dims[1:])],
            "b": [(b,) for b in dims[1:]]}


def param_shape_dtypes(cfg: GCNConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry run's shapes)."""
    return meta_tree(param_shapes(cfg), cfg.dtype)


def init_params(cfg: GCNConfig, generator: torch.Generator, *, device=None):
    """Weights N(0, 1/fan_in) from ``generator`` (the JAX law, other
    numbers), biases 0."""
    dev = resolve_device(device)
    dims = _dims(cfg)
    return {"w": [(torch.randn((a, b), generator=generator, device=dev)
                   * a ** -0.5).to(cfg.dtype)
                  for a, b in zip(dims[:-1], dims[1:])],
            "b": [torch.zeros((b,), dtype=cfg.dtype, device=dev)
                  for b in dims[1:]]}


def params_from_numpy(cfg: GCNConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays, cast
    to ``cfg.dtype`` on ``device``; every leaf a copy."""
    return copy_from_numpy(param_shapes(cfg), tree, cfg.dtype,
                           resolve_device(device))


@f32_accumulation()
def forward(params, cfg: GCNConfig, batch: GraphBatch):
    n = batch.node_feat.shape[0]
    x = batch.node_feat.to(cfg.dtype)
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = spmm(x @ w, batch, n, norm=cfg.norm) + b
        if i < len(params["w"]) - 1:
            x = F.relu(x)
    return x


def loss_fn(params, cfg: GCNConfig, batch: GraphBatch):
    return node_loss(forward(params, cfg, batch), batch)
