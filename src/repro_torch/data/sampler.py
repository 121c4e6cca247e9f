"""Fanout neighbor sampler (GraphSAGE-style): a bounded A1 traversal.

Port of ``repro/data/sampler.py``.  Sampling a 2-hop neighborhood with
fanouts (15, 10) is an A1 multi-hop query with per-hop capacity, sampled
instead of fast-failed.  Two implementations:

  * :func:`fanout_sample`: static shapes, from a CSR held in tensors on
    the device (the minibatch_lg training path);
  * :func:`fanout_sample_db`: host path against a live ``GraphDB``, one
    ``get_edges`` a frontier vertex.

Layered layout (static shapes): node slots = [seeds | hop-1 | hop-2 ...],
hop-k edges connect slot ranges; padding edges carry src = -1.

Draws: the JAX sampler takes ``randint(sub, (n, f), 0, 2**31 - 1)`` after
a key split a hop; here :func:`hop_draws` takes the same range from a
``torch.Generator``, and :func:`sample_layers` does the rest from any
draws, so that JAX's own draws give JAX's sample bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.models.gnn.common import GraphBatch

DRAW_HIGH = 2**31 - 1          # draws are uniform in [0, DRAW_HIGH)


def csr_from_coo(n_nodes: int, src, dst, *, device=None):
    """(indptr (n_nodes + 1,), indices (E,)), both int32, of the edges
    ``src[i] -> dst[i]`` sorted stably by src: the JAX host build, on
    ``device`` (the tensors' own when they are tensors, else the GPU
    unless the caller passes ``device``)."""
    if isinstance(src, torch.Tensor):
        dev = src.device if device is None else torch.device(device)
    else:
        dev = resolve_device(device)
    src = torch.as_tensor(src).to(dev)
    dst = torch.as_tensor(dst).to(dev)
    order = torch.argsort(src, stable=True)
    counts = torch.bincount(src[order], minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, dst[order].to(torch.int32)


def hop_draws(generator: torch.Generator, n: int, f: int):
    """(n, f) int32 draws uniform in [0, DRAW_HIGH) on the generator's
    device."""
    return torch.randint(0, DRAW_HIGH, (n, f), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _hop(indptr, indices, frontier, r):
    """One hop: the neighbours (n, f) that the draws ``r`` pick, -1 where
    the parent is -1 or has none.  JAX's gathers wrap a -1 index to the
    last entry and clamp one past the end; these gathers take the same
    rows (clamped first, so that no index leaves its tensor), and the
    masked entries are -1 all the same."""
    wrap = torch.where(frontier < 0, frontier + indptr.shape[0],
                       frontier).long()
    nxt = (frontier.long() + 1).clamp(max=indptr.shape[0] - 1)
    start = indptr[wrap]
    deg = indptr[nxt] - start
    r = r % torch.clamp(deg, min=1)[:, None]
    pos = (start[:, None] + r).long().clamp(0, indices.shape[0] - 1)
    ok = (deg > 0)[:, None] & (frontier >= 0)[:, None]
    return torch.where(ok, indices[pos], -1), ok


def sample_layers(indptr, indices, seeds, draws):
    """The layered sample of :func:`fanout_sample` from ``draws``, one
    (n_k, f_k) int32 tensor a hop (n_k the hop's frontier).  Returns
    (node_gids, edge_src, edge_dst), all int32."""
    dev = seeds.device
    B = seeds.shape[0]
    node_gids = [seeds.to(torch.int32)]
    e_src, e_dst = [], []
    frontier = node_gids[0]
    base_prev, base_next = 0, B
    for r in draws:
        n, f = r.shape
        if n != frontier.shape[0]:
            raise ValueError(f"draws of {n} rows for a frontier of "
                             f"{frontier.shape[0]}")
        nbr, ok = _hop(indptr, indices, frontier, r)
        okf = ok.expand(n, f).reshape(-1)
        src_slots = base_next + torch.arange(n * f, dtype=torch.int32,
                                             device=dev)
        dst_slots = base_prev + torch.arange(
            n, dtype=torch.int32, device=dev).repeat_interleave(f)
        e_src.append(torch.where(okf, src_slots, -1))
        e_dst.append(dst_slots)
        frontier = nbr.reshape(-1).to(torch.int32)
        node_gids.append(frontier)
        base_prev = base_next
        base_next = base_next + n * f
    return (torch.cat(node_gids), torch.cat(e_src).to(torch.int32),
            torch.cat(e_dst).to(torch.int32))


def fanout_sample(indptr, indices, seeds, generator: torch.Generator, *,
                  fanouts: tuple):
    """Sample a layered neighborhood.  Returns (node_gids, edge_src,
    edge_dst) where edge indices refer to *slot positions*:
      slots [0, B)                      = seeds
      slots [B, B + B*f1)               = hop-1 samples
      slots [.., + B*f1*f2)             = hop-2 samples ...
    Edges are (hop-k slot) -> (hop-(k-1) slot), src = -1 where the parent
    had no neighbors (sampled with replacement, GraphSAGE semantics).
    Each hop's draws come from ``generator`` (on the tensors' device)."""
    draws, n = [], seeds.shape[0]
    for f in fanouts:
        draws.append(hop_draws(generator, n, f))
        n *= f
    return sample_layers(indptr, indices, seeds, draws)


def build_sampled_batch(features, labels, indptr, indices, seeds,
                        generator: torch.Generator, *, fanouts: tuple,
                        n_classes: Optional[int] = None) -> GraphBatch:
    """Assemble a GraphBatch from a fanout sample (features gathered by
    global id; loss is computed on seed slots only)."""
    return sampled_batch(features, labels, seeds,
                         *fanout_sample(indptr, indices, seeds, generator,
                                        fanouts=fanouts))


def sampled_batch(features, labels, seeds, gids, es, ed) -> GraphBatch:
    """The GraphBatch of a sample (node_gids, edge_src, edge_dst) of
    ``seeds``: features by gid (zero at a -1 slot), the seeds' labels
    (-1 elsewhere), the seed slots alone trained on."""
    ok = gids >= 0
    rows = torch.where(ok, gids, 0).long()
    feat = features[rows] * ok[:, None].to(features.dtype)
    B = seeds.shape[0]
    N = gids.shape[0]
    lbl = torch.full((N,), -1, dtype=torch.int32, device=gids.device)
    lbl[:B] = labels[seeds.long()].to(torch.int32)
    mask = torch.zeros((N,), dtype=torch.bool, device=gids.device)
    mask[:B] = True
    return GraphBatch(node_feat=feat, edge_src=es, edge_dst=ed,
                      labels=lbl, train_mask=mask)


def fanout_sample_db(db, seed_gids, *, fanouts: tuple, etype: int = -1,
                     seed: int = 0, cap: int = 4096):
    """Host-path sampler against a live GraphDB (A1 traversal per hop).
    ``cap`` is not passed on to ``get_edges``, as in the JAX sampler:
    enumeration keeps ``get_edges``' own default."""
    rng = np.random.default_rng(seed)
    nodes = [np.asarray(seed_gids, np.int64)]
    e_src, e_dst = [], []
    frontier = np.asarray(seed_gids, np.int64)
    base_prev, base_next = 0, len(frontier)
    for f in fanouts:
        layer = []
        for i, g in enumerate(frontier):
            nbrs = ([n for n, _ in db.get_edges(int(g), etype=etype)]
                    if g >= 0 else [])
            for j in range(f):
                if nbrs:
                    layer.append(int(rng.choice(nbrs)))
                    e_src.append(base_next + i * f + j)
                else:
                    layer.append(-1)
                    e_src.append(-1)
                e_dst.append(base_prev + i)
        nodes.append(np.asarray(layer, np.int64))
        frontier = np.asarray(layer, np.int64)
        base_prev = base_next
        base_next += len(layer)
    return (np.concatenate(nodes), np.asarray(e_src, np.int32),
            np.asarray(e_dst, np.int32))
