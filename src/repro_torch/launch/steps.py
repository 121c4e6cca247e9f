"""The train and serve steps of the model zoo on one device.

Port of the step functions of ``repro/launch/steps.py``: ``pick_opt``; the
LM train cell's geometry and ``train_step``; the GNN cells' geometry,
config and ``train_step``; the recsys cells' ``train_step`` and
``serve_step``.  A JAX cell is a jitted step over a device mesh with
sharded parameters, optimizer state and gradient accumulator; here one
device holds them all, so there is no sharding, and a train step updates
the parameters and moments in place.  Steps take their matmuls with f32
accumulation, backward included, as XLA does.  (The cells themselves,
``build_cell`` with its shardings, come with ROADMAP queue 1 item 16.)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import f32_accumulation
from repro_torch.core.tree import leaves, set_path, tree_map, value_and_grad
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.gnn import gcn, meshgraphnet, nequip, sage
from repro_torch.optim.optimizers import (AdafactorConfig, AdamWConfig,
                                          opt_update)


def pick_opt(n_params: int):
    """Optimizer selection by memory budget: factored second moments above
    100B params, bf16 moments above 10B, fp32 below."""
    if n_params > 100e9:
        return AdafactorConfig(lr=1e-3)
    if n_params > 10e9:
        return AdamWConfig(state_dtype=torch.bfloat16)
    return AdamWConfig()


def train_geometry(cell, *, reduced: bool = False) -> tuple:
    """(accum, micro-batch, seq) of an LM train cell on one device, as the
    JAX cell derives them (``reduced`` cuts the global batch and sequence
    to 4 x 64)."""
    g = cell.geometry
    gb, S = g["global_batch"], g["seq_len"]
    if reduced:
        gb, S = 4, 64
    accum = max(1, min(g.get("accum", 8), gb))
    mb = min(max(1, gb // accum), gb)
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
