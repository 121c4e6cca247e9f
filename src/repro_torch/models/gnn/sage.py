"""GraphSAGE (arXiv:1706.02216): mean aggregator.

Port of ``repro/models/gnn/sage.py``.  graphsage-reddit assigned config: 2
layers, d_hidden 128; its minibatch cell samples fanouts (15, 10) with
``data/sampler.py``.  Params: ``{"w_self", "w_nbr", "b"}``, a list a
layer each, laid out like the JAX pytree.
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
class SageConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    dtype: Any = torch.float32


def param_shapes(cfg: SageConfig) -> dict:
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    ws = [(a, b) for a, b in zip(dims[:-1], dims[1:])]
    return {"w_self": list(ws), "w_nbr": list(ws),
            "b": [(b,) for b in dims[1:]]}


def param_shape_dtypes(cfg: SageConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry run's shapes)."""
    return meta_tree(param_shapes(cfg), cfg.dtype)


def init_params(cfg: SageConfig, generator: torch.Generator, *, device=None):
    """Weights N(0, 1/fan_in) from ``generator`` (the JAX law, other
    numbers), biases 0."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    p = {"w_self": [], "w_nbr": [], "b": []}
    for i, (a, b) in enumerate(shapes["w_self"]):
        for name in ("w_self", "w_nbr"):
            p[name].append((torch.randn((a, b), generator=generator,
                                        device=dev) * a ** -0.5
                            ).to(cfg.dtype))
        p["b"].append(torch.zeros((b,), dtype=cfg.dtype, device=dev))
    return p


def params_from_numpy(cfg: SageConfig, tree, *, device=None) -> dict:
    """The port's params from a JAX param tree held as numpy arrays, cast
    to ``cfg.dtype`` on ``device``; every leaf a copy."""
    return copy_from_numpy(param_shapes(cfg), tree, cfg.dtype,
                           resolve_device(device))


@f32_accumulation()
def forward(params, cfg: SageConfig, batch: GraphBatch):
    n = batch.node_feat.shape[0]
    x = batch.node_feat.to(cfg.dtype)
    L = len(params["b"])
    for i in range(L):
        nbr = spmm(x, batch, n, norm="mean")
        x = x @ params["w_self"][i] + nbr @ params["w_nbr"][i] \
            + params["b"][i]
        if i < L - 1:
            x = F.relu(x)
            # l2-normalize (SAGE's stability trick)
            x = x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-6)
    return x


def loss_fn(params, cfg: SageConfig, batch: GraphBatch):
    return node_loss(forward(params, cfg, batch), batch)
