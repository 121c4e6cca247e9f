"""Synthetic graph datasets shaped like the assigned GNN cells.

Port of ``repro/data/graphs.py``: the same numpy draws in the same order,
so that a seed gives the same arrays bit for bit, as tensors on the
device (the GPU unless the caller passes ``device``).

  full_graph_sm   cora-like:    2,708 nodes / 10,556 edges / 1,433 features
  minibatch_lg    reddit-like:  233 k nodes / 115 M edges, fanout-sampled
  ogb_products    2.45 M nodes / 61.9 M edges / 100 features
  molecule        30-atom molecular graphs, batch 128

:func:`graph_batch_shape_dtypes` gives the dry run's batch of ``meta``
tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.models.gnn.common import GraphBatch


def _t(a, dev, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def synthetic_graph_batch(n_nodes: int, n_edges: int, d_feat: int, *,
                          n_classes: int = 16, seed: int = 0,
                          with_positions: bool = False,
                          undirected: bool = True,
                          dtype=torch.float32, device=None) -> GraphBatch:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # power-law-ish degree: sample endpoints with zipf weights
    w = 1.0 / np.power(np.arange(1, n_nodes + 1), 0.8)
    w /= w.sum()
    half = n_edges // 2 if undirected else n_edges
    src = rng.choice(n_nodes, size=half, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=half).astype(np.int32)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    pad = n_edges - src.shape[0]
    if pad > 0:
        src = np.concatenate([src, np.full(pad, -1, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    mask = rng.uniform(size=n_nodes) < 0.3
    return GraphBatch(
        node_feat=_t(feat, dev, dtype),
        edge_src=_t(src, dev), edge_dst=_t(dst, dev),
        labels=_t(labels, dev), train_mask=_t(mask, dev),
        positions=(_t(rng.normal(size=(n_nodes, 3)), dev, dtype)
                   if with_positions else None))


def cora_like(scale: float = 1.0, seed: int = 0, *,
              device=None) -> GraphBatch:
    n = max(int(2708 * scale), 32)
    e = max(int(10556 * scale), 64)
    return synthetic_graph_batch(n, e, max(int(1433 * scale), 16),
                                 n_classes=7, seed=seed, device=device)


def reddit_like(scale: float = 1.0, seed: int = 0, *,
                device=None) -> GraphBatch:
    n = max(int(232_965 * scale), 64)
    e = max(int(114_615_892 * scale), 256)
    return synthetic_graph_batch(n, e, max(int(602 * scale), 16),
                                 n_classes=41, seed=seed, device=device)


def molecule_batch(batch: int = 128, n_nodes: int = 30, n_edges: int = 64,
                   *, n_species: int = 8, seed: int = 0,
                   dtype=torch.float32, device=None) -> GraphBatch:
    """Batched small molecules: one flat COO graph with graph_ids."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = batch * n_nodes
    srcs, dsts = [], []
    for g in range(batch):
        base = g * n_nodes
        s = rng.integers(0, n_nodes, n_edges // 2)
        d = rng.integers(0, n_nodes, n_edges // 2)
        srcs.append(np.concatenate([s, d]) + base)
        dsts.append(np.concatenate([d, s]) + base)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    species = rng.integers(0, n_species, N).astype(np.float32)[:, None]
    pos = rng.normal(size=(N, 3)).astype(np.float32) * 2.0
    gid = np.repeat(np.arange(batch, dtype=np.int32), n_nodes)
    energy = rng.normal(size=batch).astype(np.float32)
    return GraphBatch(
        node_feat=_t(species, dev, dtype),
        edge_src=_t(src, dev), edge_dst=_t(dst, dev),
        labels=_t(energy, dev),
        train_mask=torch.ones((batch,), dtype=torch.bool, device=dev),
        positions=_t(pos, dev, dtype),
        graph_ids=_t(gid, dev), n_graphs=batch)


def graph_batch_shape_dtypes(n_nodes: int, n_edges: int, d_feat: int, *,
                             with_positions: bool = False,
                             graph_ids: bool = False, n_graphs: int = 1,
                             label_shape: Optional[tuple] = None,
                             dtype=torch.float32) -> GraphBatch:
    """A GraphBatch of ``meta`` tensors for the dry run (no allocation)."""
    def sds(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    lbl = label_shape or (n_nodes,)
    return GraphBatch(
        node_feat=sds((n_nodes, d_feat), dtype),
        edge_src=sds((n_edges,), torch.int32),
        edge_dst=sds((n_edges,), torch.int32),
        labels=sds(lbl, torch.int32 if len(lbl) == 1 and not graph_ids
                   else torch.float32),
        train_mask=sds(lbl[:1], torch.bool),
        positions=sds((n_nodes, 3), dtype) if with_positions else None,
        graph_ids=sds((n_nodes,), torch.int32) if graph_ids else None,
        n_graphs=n_graphs)
