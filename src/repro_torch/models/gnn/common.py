"""Shared GNN machinery: the COO GraphBatch contract and message passing.

Port of ``repro/models/gnn/common.py``.  Every GNN cell (full-batch,
fanout-sampled minibatch, batched small molecules) is one static-shape
:class:`GraphBatch` of tensors.  Message passing is a gather of the source
rows and an ``index_add`` onto the destinations (``jax.ops.segment_sum``
there), into N + 1 rows whose last, the padding edges' sink, is dropped.
On the CPU the adds run in edge order; on a GPU they are atomic, so the
order of a row's sum, and its last bits, vary from run to run.
``constrain_batch`` marks the JAX package's sharding of a batch
(``dist/sharding.py``), and ``mlp_shape_dtypes`` gives the dry run's
``meta`` shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.tree import meta_tree
from repro_torch.dist.sharding import constrain


@dataclasses.dataclass
class GraphBatch:
    """Static-shape COO graph (padded; src < 0 marks padding edges)."""
    node_feat: torch.Tensor                  # (N, F)
    edge_src: torch.Tensor                   # (E,) i32, -1 = padding
    edge_dst: torch.Tensor                   # (E,) i32
    labels: torch.Tensor                     # (N,) or (G,) i32 / f32
    train_mask: torch.Tensor                 # (N,) or (G,) bool
    positions: Optional[torch.Tensor] = None   # (N, 3) for equivariant models
    edge_feat: Optional[torch.Tensor] = None   # (E, Fe)
    graph_ids: Optional[torch.Tensor] = None   # (N,) for per-graph readout
    n_graphs: int = 1

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _sink(ok, idx, n_nodes: int):
    """Edge index with padding edges sent to the sink row ``n_nodes``."""
    return torch.where(ok, idx, n_nodes).long()


def degree(batch: GraphBatch, n_nodes: int, direction: str = "dst"):
    idx = batch.edge_dst if direction == "dst" else batch.edge_src
    ok = batch.edge_src >= 0
    return torch.zeros(n_nodes + 1, dtype=torch.float32,
                       device=idx.device).index_add(
        0, _sink(ok, idx, n_nodes), ok.float())[:n_nodes]


def gather_src(x, batch: GraphBatch):
    """x[src] with padding masked to zero (the A1 'read remote vertex')."""
    ok = batch.edge_src >= 0
    rows = torch.where(ok, batch.edge_src, 0).long()
    return x[rows] * ok[:, None].to(x.dtype)


def scatter_dst(msgs, batch: GraphBatch, n_nodes: int, *, mode="sum"):
    """Segment-sum the messages onto their destination nodes."""
    ok = batch.edge_src >= 0
    out = torch.zeros((n_nodes + 1,) + msgs.shape[1:], dtype=msgs.dtype,
                      device=msgs.device).index_add(
        0, _sink(ok, batch.edge_dst, n_nodes), msgs)[:n_nodes]
    if mode == "mean":
        d = degree(batch, n_nodes)[:, None]
        out = out / torch.clamp(d, min=1.0)
    return out


def spmm(x, batch: GraphBatch, n_nodes: int, *, norm: Optional[str] = None):
    """One propagation: A~ x with optional 'sym' (GCN) or 'mean' norm."""
    msgs = gather_src(x, batch)
    if norm == "sym":
        d = torch.clamp(degree(batch, n_nodes), min=1.0)
        dinv = torch.rsqrt(d)
        ok = batch.edge_src >= 0
        coef = (dinv[torch.where(ok, batch.edge_src, 0).long()]
                * dinv[torch.where(ok, batch.edge_dst, 0).long()])
        return scatter_dst(msgs * coef[:, None], batch, n_nodes)
    if norm == "mean":
        return scatter_dst(msgs, batch, n_nodes, mode="mean")
    return scatter_dst(msgs, batch, n_nodes)


# ---------------------------------------------------------------------------
# plain MLP (+ LayerNorm) building block
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, dims, *, dtype=torch.float32,
             layer_norm=False, device=None):
    """Weights N(0, 1/fan_in) drawn from ``generator`` (on ``device``, the
    generator's device by default), biases 0, LayerNorm scale 1 and bias
    0."""
    dev = generator.device if device is None else torch.device(device)
    params = {"w": [], "b": []}
    for a, b in zip(dims[:-1], dims[1:]):
        params["w"].append((torch.randn((a, b), generator=generator,
                                        device=dev) * a ** -0.5).to(dtype))
        params["b"].append(torch.zeros((b,), dtype=dtype, device=dev))
    if layer_norm:
        params["ln_scale"] = torch.ones((dims[-1],), dtype=dtype, device=dev)
        params["ln_bias"] = torch.zeros((dims[-1],), dtype=dtype, device=dev)
    return params


def mlp_apply(params, x, *, act=F.relu, final_act=False):
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    if "ln_scale" in params:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-6)
        x = x * params["ln_scale"] + params["ln_bias"]
    return x


def mlp_shapes(dims, layer_norm=False) -> dict:
    """The shapes of :func:`mlp_init`'s tree."""
    p = {"w": [(a, b) for a, b in zip(dims[:-1], dims[1:])],
         "b": [(b,) for b in dims[1:]]}
    if layer_norm:
        p["ln_scale"] = p["ln_bias"] = (dims[-1],)
    return p


def mlp_shape_dtypes(dims, *, dtype=torch.float32, layer_norm=False):
    """:func:`mlp_init`'s tree as ``meta`` tensors (the dry run's)."""
    return meta_tree(mlp_shapes(dims, layer_norm), dtype)


def constrain_batch(batch: GraphBatch, replicate_nodes: bool = True):
    """Sharding: edges data-parallel over the whole mesh; nodes replicated
    (full batch) or split on 'model' (huge graphs)."""
    es = constrain(batch.edge_src, ("batch",))
    ed = constrain(batch.edge_dst, ("batch",))
    nf = batch.node_feat if replicate_nodes else constrain(
        batch.node_feat, ("tensor", None))
    return dataclasses.replace(batch, edge_src=es, edge_dst=ed, node_feat=nf)


def node_loss(logits, batch: GraphBatch):
    """Masked node-classification cross-entropy and accuracy (GCN and
    SAGE's ``loss_fn``): labels < 0 and nodes off ``train_mask`` count
    for nothing."""
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    labels = torch.clamp(batch.labels, min=0).long()
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    mask = batch.train_mask & (batch.labels >= 0)
    n = torch.clamp(mask.sum(), min=1)
    loss = torch.sum(nll * mask) / n
    acc = torch.sum((logits.argmax(-1) == batch.labels) * mask) / n
    return loss, {"acc": acc}
