"""Cells and the train and serve steps of the model zoo.

Port of ``repro/launch/steps.py``: ``pick_opt``; the LM train cell's
geometry and ``train_step``; the GNN cells' geometry, config and
``train_step``; the recsys cells' ``train_step`` and ``serve_step``; and
:func:`build_cell`, which gives each (arch x shape x mesh) a :class:`Cell`:

    fn             the step function (train / prefill / decode / serve /
                   retrieval / query / update)
    args           its inputs as ``meta`` tensors (shapes and dtypes, no
                   allocation: the dry run's ``ShapeDtypeStruct``s)
    in_shardings   the tree of resolved partition specs of the args on the
                   mesh (``dist/sharding.py``), or None
    model_flops    the useful flops of a step, by the JAX formula

A JAX cell is a jitted step over a device mesh with sharded parameters,
optimizer state and gradient accumulator.  Here one device holds them
all: a train step updates the parameters and moments in place, and the
specs record what the mesh would split.  Steps take their matmuls with f32
accumulation, backward included, as XLA does.  The a1 cells build the
lockstep query program (``mesh=``) or the commit-batch apply over the
store's ``meta`` shapes; both are host-driven (their waves read counts
back to size the next step), so the dry run records them without tracing
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs import registry
from repro_torch.core.precision import f32_accumulation
from repro_torch.core.tree import (get_path, leaves, map_leaves, set_path,
                                   tree_map, value_and_grad)
from repro_torch.dist.sharding import rules_context, tree_specs
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.gnn import gcn, meshgraphnet, nequip, sage
from repro_torch.optim.optimizers import (AdafactorConfig, AdamWConfig,
                                          OptState, init_opt_state,
                                          opt_update)


def pick_opt(n_params: int):
    """Optimizer selection by memory budget: factored second moments above
    100B params, bf16 moments above 10B, fp32 below."""
    if n_params > 100e9:
        return AdafactorConfig(lr=1e-3)
    if n_params > 10e9:
        return AdamWConfig(state_dtype=torch.bfloat16)
    return AdamWConfig()


def train_geometry(cell, *, reduced: bool = False,
                   batch_shards: int = 1) -> tuple:
    """(accum, micro-batch, seq) of an LM train cell, as the JAX cell
    derives them: a micro-batch of at least one sequence a batch shard
    (one on one device; ``reduced`` cuts the global batch and sequence to
    4 x 64 and the micro-batch floor to 1)."""
    g = cell.geometry
    gb, S = g["global_batch"], g["seq_len"]
    if reduced:
        gb, S = 4, 64
    accum = max(1, min(g.get("accum", 8), gb))
    mb = min(max(batch_shards if not reduced else 1, gb // accum), gb)
    return max(1, gb // mb), mb, S


def lm_train_step(params, opt_state, tokens, targets, cfg, ocfg, *,
                  backend=None):
    """One step over ``tokens``, ``targets`` (accum, micro-batch, S): the
    gradients of the micro-batches summed in float32 and divided by accum,
    then :func:`~repro_torch.optim.optimizers.opt_update`.  Parameters and
    moments are updated in place; returns (params, opt_state, {"loss",
    "gnorm"}).  With a non-finite loss nothing is updated (the trainer's
    circuit breaker: the update happens in place, so it is decided here)
    and gnorm is NaN."""
    accum = tokens.shape[0]
    gacc, loss_sum = None, 0.0
    for a in range(accum):
        (loss, _), grads = T.value_and_grad(params, cfg, tokens[a],
                                            targets[a], backend=backend)
        loss_sum = loss_sum + loss
        if gacc is None:
            # each leaf is cast and its bf16 gradient dropped before the
            # next: the two precisions never both hold the whole model
            for path, g in leaves(grads):
                set_path(grads, path, g.float())
            del g
            gacc = grads
        else:
            tree_map(lambda acc, g: acc.add_(g), gacc, grads)
        del grads
    loss = loss_sum / accum
    if not bool(torch.isfinite(loss)):
        return params, opt_state, {"loss": loss,
                                   "gnorm": torch.full_like(loss, torch.nan)}
    if accum > 1:
        tree_map(lambda g: g.div_(accum), gacc)
    params, opt_state, gnorm = opt_update(params, gacc, opt_state, ocfg)
    return params, opt_state, {"loss": loss, "gnorm": gnorm}


# ---------------------------------------------------------------------------
# GNN and recsys cells
# ---------------------------------------------------------------------------

def _update(params, opt_state, loss, grads, ocfg):
    """``opt_update`` unless the loss is not finite (the trainer's circuit
    breaker: the update happens in place, so it is decided here)."""
    if not bool(torch.isfinite(loss)):
        return params, opt_state, {"loss": loss,
                                   "gnorm": torch.full_like(loss, torch.nan)}
    params, opt_state, gnorm = opt_update(params, grads, opt_state, ocfg)
    return params, opt_state, {"loss": loss, "gnorm": gnorm}


def gnn_geometry(cell, reduced: bool = False) -> tuple:
    """(n_nodes, n_edges, d_feat, n_graphs) of a GNN shape cell, as the JAX
    cell derives them (``reduced`` cuts them for CPU runs).  A sampled
    cell's nodes and edges are those of a fanout sample of its batch."""
    g = cell.geometry
    if g.get("sampled"):
        b, (f1, f2) = g["batch_nodes"], g["fanout"]
        if reduced:
            b, f1, f2 = 8, 3, 2
        n = b * (1 + f1 + f1 * f2)
        e = b * f1 + b * f1 * f2
        return n, e, (g["d_feat"] if not reduced else 16), 1
    if g.get("molecule"):
        bt = g["batch"] if not reduced else 4
        return (bt * g["n_nodes"], bt * g["n_edges"],
                g["d_feat"] if not reduced else 8, bt)
    if reduced:
        return 64, 256, 16, 1
    return g["n_nodes"], g["n_edges"], g["d_feat"], 1


GNN_MODULES = {gcn.GCNConfig: gcn, sage.SageConfig: sage,
               meshgraphnet.MGNConfig: meshgraphnet,
               nequip.NequIPConfig: nequip}


def gnn_module(cfg):
    """The model module of a GNN config."""
    return GNN_MODULES[type(cfg)]


def gnn_cell_config(base, cell, reduced: bool = False):
    """The config a GNN cell trains: ``base`` with ``d_in`` the cell's
    feature width (GCN, SAGE, MGN), or ``base`` itself (NequIP, whose input
    is the species column)."""
    if isinstance(base, nequip.NequIPConfig):
        return base
    gnn_module(base)
    return dataclasses.replace(base, d_in=gnn_geometry(cell, reduced)[2])


@f32_accumulation()
def gnn_train_step(params, opt_state, batch, cfg, ocfg):
    """One AdamW step of a GNN on ``batch`` (a GraphBatch), in place;
    returns (params, opt_state, {"loss", "gnorm"})."""
    (loss, _), grads = value_and_grad(gnn_module(cfg).loss_fn, params, cfg,
                                      batch)
    return _update(params, opt_state, loss, grads, ocfg)


def recsys_batch(cell, reduced: bool = False) -> int:
    """The batch of a recsys shape cell (8 when ``reduced``)."""
    return cell.geometry["batch"] if not reduced else 8


@f32_accumulation()
def recsys_train_step(params, opt_state, hist, tgt, dense, labels, cfg,
                      ocfg):
    """One AdamW step of BST on a batch, in place; returns (params,
    opt_state, {"loss", "gnorm"}).  The item table's gradient is dense."""
    (loss, _), grads = value_and_grad(R.loss_fn, params, cfg, hist, tgt,
                                      dense, labels)
    return _update(params, opt_state, loss, grads, ocfg)


@torch.no_grad()
def recsys_serve_step(params, hist, tgt, dense, cfg):
    """BST's scores (logits, (B,) float32) for a batch."""
    return R.forward(params, cfg, hist, tgt, dense)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_id: str
    fn: Any
    args: tuple
    in_shardings: Any
    model_flops: float = 0.0        # 6ND-style useful flops (global, /step)
    note: str = ""
    model_cfg: Any = None           # the exact config this cell runs


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _batch_shards(mesh):
    return math.prod(mesh.axis_size(a) for a in _batch_axes(mesh))


def _spec(*entries) -> tuple:
    """A spec of explicit entries, as ``PartitionSpec`` normalizes them: a
    tuple of one mesh axis is that axis, an empty one None."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else (e or None) if isinstance(e, tuple) else e
                 for e in entries)


def _replicated(tree):
    """The spec ``()`` for every tensor of ``tree``."""
    return map_leaves(lambda t: (), tree)


def _opt_axes(params, params_axes, ocfg):
    """Optimizer-state logical axes in ``init_opt_state``'s layout."""
    if isinstance(ocfg, AdamWConfig):
        return OptState(step=(), m=params_axes, v=params_axes)
    m_ax = tree_map(lambda p: (), params)
    v_ax = tree_map(lambda p: None, params)
    for path, p in leaves(params):
        a = get_path(params_axes, path)
        if (p.dim() >= 2 and p.shape[-1] >= ocfg.min_dim_factored
                and p.shape[-2] >= ocfg.min_dim_factored):
            a = (tuple(a[:-1]), tuple(a[:-2]) + (a[-1],))
        set_path(v_ax, path, a)
    return OptState(step=(), m=m_ax, v=v_ax)


def _lm_cell(spec, cell, mesh, *, reduced=False) -> Cell:
    cfg = spec.reduced if reduced else spec.model
    # sharding-rule overrides are tuned on (and scoped to) the train cells;
    # serve-path cells run the default parallelism plan
    rules = dict(spec.rules_override) if cell.kind == "train" else {}
    g = cell.geometry
    params = T.param_shape_dtypes(cfg)
    paxes = T.logical_axes(cfg)
    pshard = tree_specs(paxes, rules=rules, mesh=mesh)
    raw_b = rules.get("batch", _batch_axes(mesh))
    if raw_b is None:
        raw_b = ()
    elif not isinstance(raw_b, tuple):
        raw_b = (raw_b,)
    batch_ax = tuple(a for a in raw_b if a in mesh.axis_names) or None
    bs = math.prod(mesh.axis_size(a) for a in (batch_ax or ()))

    if cell.kind == "train":
        accum, mb, S = train_geometry(cell, reduced=reduced, batch_shards=bs)
        gb = 4 if reduced else g["global_batch"]
        ocfg = pick_opt(cfg.n_params())
        orules = {**rules, **spec.opt_rules_override}
        oshard = tree_specs(_opt_axes(params, paxes, ocfg), rules=orules,
                            mesh=mesh)
        opt = init_opt_state(params, ocfg)

        def train_step(params, opt_state, tokens, targets):
            return lm_train_step(params, opt_state, tokens, targets, cfg,
                                 ocfg)

        tok = _meta((accum, mb, S), torch.int32)
        tshard = _spec(None, batch_ax if mb % bs == 0 else None, None)
        return Cell(spec.arch_id, cell.shape_id, train_step,
                    (params, opt, tok, tok), (pshard, oshard, tshard, tshard),
                    model_flops=6.0 * cfg.n_active_params() * gb * S)

    B, S = (2, 64) if reduced else (g["global_batch"], g["seq_len"])
    if cell.kind == "prefill":
        def prefill_step(params, tokens):
            return T.prefill(params, cfg, tokens)

        tshard = _spec(batch_ax if B % bs == 0 else None, None)
        return Cell(spec.arch_id, cell.shape_id, prefill_step,
                    (params, _meta((B, S), torch.int32)), (pshard, tshard),
                    model_flops=2.0 * cfg.n_active_params() * B * S)

    # decode (decode_32k / long_500k)
    cache = T.kv_cache_shape_dtypes(cfg, B, S)
    cache_axes = [(("layers", "batch", None, "kv_seq", None),) * 2
                  for _ in cfg.block_pattern]
    bspec = batch_ax if B % bs == 0 else None
    cshard = tree_specs(cache_axes, rules={**rules, "batch": bspec},
                        mesh=mesh)

    def decode_step(params, tokens, cache, pos):
        return T.decode_step(params, cfg, tokens, cache, pos)

    return Cell(spec.arch_id, cell.shape_id, decode_step,
                (params, _meta((B, 1), torch.int32), cache,
                 _meta((), torch.int32)),
                (tree_specs(paxes, rules=rules, mesh=mesh),
                 _spec(bspec, None),
                 cshard, ()),
                model_flops=2.0 * cfg.n_active_params() * B)


def _gnn_cell(spec, cell, mesh, *, reduced=False) -> Cell:
    from repro_torch.data.graphs import graph_batch_shape_dtypes
    N, E, dF, n_graphs = gnn_geometry(cell, reduced)
    E = _pad_to(E, mesh.size)      # edges shard over the whole mesh
    # huge graphs: node arrays split on 'model' (A1-style routed gathers);
    # small graphs replicate nodes
    huge = N > 1_000_000
    if huge:
        N = _pad_to(N, mesh.axis_size("model"))
    base = spec.reduced if reduced else spec.model
    cfg = gnn_cell_config(base, cell, reduced)
    mod = gnn_module(cfg)
    edge_spec = _spec(tuple(mesh.axis_names))
    node_spec = ("model",) if huge else ()
    fam = type(cfg)
    needs_pos = fam in (meshgraphnet.MGNConfig, nequip.NequIPConfig)
    if fam is nequip.NequIPConfig:
        label_shape = (n_graphs,)
    elif fam is meshgraphnet.MGNConfig:
        label_shape = (N, 3)
    else:
        label_shape = (N,)
    batch = graph_batch_shape_dtypes(
        N, E, dF, with_positions=needs_pos,
        graph_ids=fam is nequip.NequIPConfig, n_graphs=n_graphs,
        label_shape=label_shape)
    mask_n = batch.train_mask.shape[0]
    batch_spec = dataclasses.replace(
        batch, node_feat=node_spec, edge_src=edge_spec, edge_dst=edge_spec,
        labels=() if not huge else (node_spec if label_shape[0] == N
                                    else ()),
        train_mask=() if mask_n != N or not huge else node_spec,
        positions=node_spec if needs_pos else None,
        graph_ids=node_spec if fam is nequip.NequIPConfig else None)
    params = mod.param_shape_dtypes(cfg)
    ocfg = AdamWConfig()
    opt = init_opt_state(params, ocfg)

    def train_step(params, opt_state, batch):
        return gnn_train_step(params, opt_state, batch, cfg, ocfg)

    # useful flops: gather+scatter ~ 4*E*d + dense transforms per model
    d_h = getattr(cfg, "d_hidden", getattr(cfg, "mul", 32))
    layers = getattr(cfg, "n_layers", 2)
    mf = 3 * (2.0 * E * d_h + 2.0 * N * dF * d_h) * layers
    return Cell(spec.arch_id, cell.shape_id, train_step,
                (params, opt, batch),
                (_replicated(params), _replicated(opt), batch_spec),
                model_flops=mf, model_cfg=cfg)


def _recsys_cell(spec, cell, mesh, *, reduced=False) -> Cell:
    from repro_torch.data.recsys import bst_batch_shape_dtypes
    cfg = spec.reduced if reduced else spec.model
    g = cell.geometry
    params = R.param_shape_dtypes(cfg)
    paxes = R.logical_axes(cfg)
    pshard = tree_specs(paxes, rules=spec.rules_override, mesh=mesh)
    batch_ax = _batch_axes(mesh)
    B = recsys_batch(cell, reduced)
    hist, tgt, dense, labels = bst_batch_shape_dtypes(
        batch=B, seq_len=cfg.seq_len, n_dense=cfg.n_dense)
    bspec = batch_ax if B >= _batch_shards(mesh) else None
    bshard, bshard2 = _spec(bspec), _spec(bspec, None)
    # ~flops: emb gather + 1 attn block over L+1 + MLP
    L1 = cfg.seq_len + 1
    mlp_f = 0
    dims = ((cfg.seq_len + 2) * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
    for a, b in zip(dims[:-1], dims[1:]):
        mlp_f += 2 * a * b
    flops_fwd = B * (4 * L1 * cfg.embed_dim ** 2
                     + 2 * L1 * L1 * cfg.embed_dim + mlp_f)

    if cell.kind == "train":
        ocfg = AdamWConfig()
        oshard = tree_specs(_opt_axes(params, paxes, ocfg),
                            rules=spec.rules_override, mesh=mesh)

        def train_step(params, opt_state, hist, tgt, dense, labels):
            return recsys_train_step(params, opt_state, hist, tgt, dense,
                                     labels, cfg, ocfg)

        return Cell(spec.arch_id, cell.shape_id, train_step,
                    (params, init_opt_state(params, ocfg), hist, tgt, dense,
                     labels),
                    (pshard, oshard, bshard2, bshard, bshard2, bshard),
                    model_flops=3 * flops_fwd)

    if cell.kind == "serve":
        def serve_step(params, hist, tgt, dense):
            return recsys_serve_step(params, hist, tgt, dense, cfg)

        return Cell(spec.arch_id, cell.shape_id, serve_step,
                    (params, hist, tgt, dense),
                    (pshard, bshard2, bshard, bshard2),
                    model_flops=flops_fwd)

    # retrieval: 1 user x 1M candidates
    C = g["n_candidates"] if not reduced else 256

    def retrieval_step(params, hist, dense, cand_ids):
        return R.retrieval_scores(params, cfg, hist, dense, cand_ids)

    return Cell(spec.arch_id, cell.shape_id, retrieval_step,
                (params, hist, dense, _meta((C,), torch.int32)),
                (pshard, (None, None), (None, None), _spec(batch_ax)),
                model_flops=flops_fwd + 2.0 * C * cfg.embed_dim)


def _a1_cell(spec, cell, mesh, *, reduced=False) -> Cell:
    from repro_torch.core import txn as txn_mod
    from repro_torch.core.query.executor import QueryCaps
    from repro_torch.core.query.executor_spmd import compile_query_spmd
    from repro_torch.core.query.ir import Hop, Plan
    from repro_torch.core.store import FIELDS, make_store_shapes
    from repro_torch.dist.mesh import ShardMesh

    storage_axes = ("data", "model")
    shape = tuple(mesh.axis_size(a) for a in storage_axes)
    cfg = dataclasses.replace(spec.reduced if reduced else spec.model,
                              n_shards=math.prod(shape))
    store = make_store_shapes(cfg)
    g = cell.geometry
    store_spec = dataclasses.replace(store, **{f: _spec(storage_axes)
                                               for f in FIELDS})

    if cell.kind == "a1_update":
        caps = txn_mod.BatchCaps()

        def upd(store, ts, *ops):
            return txn_mod.apply_batch_impl(store, cfg, ts, *ops)

        def p32(n):
            return _meta((n,), torch.int32)
        ops = (p32(caps.create_v), p32(caps.create_v), p32(caps.create_v),
               _meta((caps.create_v, cfg.d_f32), torch.float32),
               _meta((caps.create_v, cfg.d_i32), torch.int32),
               p32(caps.create_v), p32(caps.update_v),
               _meta((caps.update_v, cfg.d_f32), torch.float32),
               _meta((caps.update_v, cfg.d_i32), torch.int32),
               p32(caps.delete_v), p32(caps.delete_v), p32(caps.delete_v),
               p32(caps.create_e), p32(caps.create_e), p32(caps.create_e),
               p32(caps.create_e), p32(caps.create_e),
               p32(caps.delete_e), p32(caps.delete_e), p32(caps.delete_e),
               p32(cfg.n_shards), p32(cfg.n_shards), p32(cfg.n_shards))
        return Cell(spec.arch_id, cell.shape_id, upd,
                    (store, _meta((), torch.int32)) + ops,
                    (store_spec, ()) + ((),) * len(ops),
                    model_flops=0.0, model_cfg=cfg)

    Q = g["n_queries"] if not reduced else 4
    caps = (QueryCaps(**g["caps"]) if not reduced
            else QueryCaps(frontier=64, expand=256, bucket=32, results=8))
    if g.get("star"):
        branches = tuple(
            Plan(start_vtype=i, hops=(Hop("out", i, 2, None),),
                 terminal="count") for i in range(g["star"]))
        plan = Plan(start_vtype=-1, hops=(), terminal="count",
                    branches=branches)
        keys = _meta((g["star"], Q), torch.int32)
    else:
        hops = tuple(Hop("out", h % 3, -1, None) for h in range(g["hops"]))
        plan = Plan(start_vtype=0, hops=hops, terminal="count")
        keys = _meta((Q,), torch.int32)
    # the store's shards over the storage axes (JAX's query replicas on a
    # "pod" axis run the same program on each pod)
    smesh = ShardMesh(mesh.devices[:cfg.n_shards], storage_axes, shape)
    fn = compile_query_spmd(cfg, plan, caps, Q, smesh)
    # traversal 'useful work': ~1 gather per expanded edge per hop
    return Cell(spec.arch_id, cell.shape_id, fn,
                (store, keys, _meta((Q,), torch.bool),
                 _meta((), torch.int32)),
                None, model_flops=float(Q * caps.expand * 8),
                note="lockstep program: the shards split inside it",
                model_cfg=cfg)


def build_cell(arch_id: str, shape_id: str, mesh, *,
               reduced: bool = False) -> Cell:
    """The :class:`Cell` of (arch, shape) on ``mesh`` (a named
    :class:`~repro_torch.dist.mesh.ShardMesh`); ``reduced`` takes the
    arch's reduced config and cut geometry.  A skipped cell raises unless
    ``reduced``."""
    spec = registry.get(arch_id)
    cell = spec.cell(shape_id)
    if cell.skip and not reduced:
        raise ValueError(
            f"cell {arch_id}/{shape_id} is skipped: {cell.skip}")
    if spec.family == "lm":
        c = _lm_cell(spec, cell, mesh, reduced=reduced)
        c.model_cfg = spec.reduced if reduced else spec.model
        if spec.rules_override and cell.kind == "train":
            inner, rules = c.fn, dict(spec.rules_override)

            def fn_with_rules(*a, __inner=inner, __rules=rules, **k):
                with rules_context(__rules):
                    return __inner(*a, **k)

            c.fn = fn_with_rules
    elif spec.family == "gnn":
        c = _gnn_cell(spec, cell, mesh, reduced=reduced)
    elif spec.family == "recsys":
        c = _recsys_cell(spec, cell, mesh, reduced=reduced)
        c.model_cfg = spec.reduced if reduced else spec.model
    elif spec.family == "a1":
        c = _a1_cell(spec, cell, mesh, reduced=reduced)
    else:
        raise ValueError(spec.family)
    return c
