"""Training entry point for the model zoo on one device.

Port of ``repro/launch/train.py`` (``run_training``, ``_batch_source``)
for every arch of the port's registry (``configs/registry.py::get``) that
trains: the LM family (dense and MoE), gcn-cora, graphsage-reddit and
bst:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gcn-cora --steps 20 --device cpu

Parameters from the family's ``init_params`` with a seeded
``torch.Generator``, the optimizer of the JAX cell (``pick_opt`` for an
LM, AdamW with f32 moments otherwise), input batches shaped like the
arch's first shape cell (``train_4k``, ``full_graph_sm``, ``train_batch``)
from ``np.random.default_rng`` as the JAX trainer draws them, and the
non-finite-loss circuit breaker (a step with a non-finite loss changes
nothing).  meshgraphnet, nequip and checkpoints (``ckpt/manager.py``)
raise, naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.backend import resolve_device

CKPT_ITEM = "ROADMAP queue 1 item 15d (ckpt/manager.py)"
# arch ids of the zoo whose models are not ported yet
UNPORTED = {"meshgraphnet": "ROADMAP queue 1 item 15d (meshgraphnet.py)",
            "nequip": "ROADMAP queue 1 item 15d (nequip.py, irreps.py)"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run_training(arch=args.arch, steps=args.steps, reduced=args.reduced,
                 device=args.device)


def run_training(arch: str, *, steps: int = 50, reduced: bool = True,
                 ckpt_dir: str = None, seed: int = 0,
                 log_every: int = 10, device=None) -> dict:
    """Programmatic entry point; returns the last step's metrics."""
    if arch in UNPORTED:
        raise NotImplementedError(
            f"training {arch} is not ported yet: {UNPORTED[arch]}")
    spec = registry.get(arch)
    if spec.family == "a1":
        raise KeyError(f"{arch} is a graph store, not a trained arch")
    if ckpt_dir is not None:
        raise NotImplementedError(
            f"checkpoints (ckpt_dir) are not ported yet: {CKPT_ITEM}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    build = _lm if spec.family == "lm" else _zoo
    step_fn, params, ocfg, batches = build(spec, reduced, gen, seed, dev)
    from repro_torch.optim.optimizers import init_opt_state
    opt_state = init_opt_state(params, ocfg)
    metrics = {}
    t0 = time.time()
    for step in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             *next(batches))
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            print(f"step {step}: non-finite loss, skipping update")
            continue            # circuit breaker: the state was kept
        if step % log_every == 0:
            dt = (time.time() - t0) / (step + 1)
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['gnorm']):.3f} "
                  f"({dt*1e3:.0f} ms/step)")
    return {k: float(v) for k, v in metrics.items()}


def _lm(spec, reduced, gen, seed, dev):
    from repro_torch.launch.steps import (lm_train_step, pick_opt,
                                          train_geometry)
    from repro_torch.models.transformer import init_params
    cfg = spec.reduced if reduced else spec.model
    geo = train_geometry(spec.shapes[0], reduced=reduced)
    ocfg = pick_opt(cfg.n_params())

    def step_fn(params, opt_state, tokens, targets):
        return lm_train_step(params, opt_state, tokens, targets, cfg, ocfg)
    return (step_fn, init_params(cfg, gen, device=dev), ocfg,
            _lm_batches(cfg, geo, seed, dev))


def _zoo(spec, reduced, gen, seed, dev):
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.optim.optimizers import AdamWConfig
    cell0 = spec.shapes[0]
    ocfg = AdamWConfig()
    if spec.family == "recsys":
        cfg = spec.reduced if reduced else spec.model

        def step_fn(params, opt_state, *batch):
            return steps.recsys_train_step(params, opt_state, *batch, cfg,
                                           ocfg)
        return (step_fn, recsys.init_params(cfg, gen, device=dev), ocfg,
                _recsys_batches(cfg, steps.recsys_batch(cell0, reduced),
                                seed, dev))
    cfg = steps.gnn_cell_config(spec.reduced if reduced else spec.model,
                                cell0, reduced)

    def step_fn(params, opt_state, batch):
        return steps.gnn_train_step(params, opt_state, batch, cfg, ocfg)
    n, e, d_feat, _ = steps.gnn_geometry(cell0, reduced)
    return (step_fn,
            steps.gnn_module(cfg).init_params(cfg, gen, device=dev), ocfg,
            _gnn_batches(n, e, d_feat, seed, dev))


def _lm_batches(cfg, geometry, seed, dev):
    """Infinite iterator of (tokens, targets), each (accum, micro-batch,
    seq) int32 on ``dev``: uniform token ids, targets shifted by one."""
    accum, mb, S = geometry
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (accum, mb, S + 1))
                                .astype(np.int32))
        yield (toks[..., :-1].contiguous().to(dev),
               toks[..., 1:].contiguous().to(dev))


def _recsys_batches(cfg, batch, seed, dev):
    """Infinite iterator of BST batches (``bst_batch`` with seed, seed+1,
    ...)."""
    from repro_torch.data.recsys import bst_batch
    i = 0
    while True:
        yield bst_batch(batch=batch, seq_len=cfg.seq_len,
                        n_items=cfg.n_items, n_dense=cfg.n_dense,
                        seed=seed + i, device=dev)
        i += 1


def _gnn_batches(n, e, d_feat, seed, dev):
    """Infinite iterator of 1-tuples of GraphBatch: uniform random graphs
    of the cell's geometry from ``default_rng(seed + i)``, features
    ``|N(0, 1)| % 4``, four label classes, every node trained on (the JAX
    trainer's full-batch stand-in for every GNN cell)."""
    from repro_torch.models.gnn.common import GraphBatch
    i = 0
    while True:
        r = np.random.default_rng(seed + i)
        feat = np.abs(r.normal(size=(n, d_feat))) % 4
        src, dst = r.integers(0, n, e), r.integers(0, n, e)
        labels = r.integers(0, 4, (n,))
        yield (GraphBatch(
            node_feat=torch.from_numpy(feat).to(dev, torch.float32),
            edge_src=torch.from_numpy(src).to(dev, torch.int32),
            edge_dst=torch.from_numpy(dst).to(dev, torch.int32),
            labels=torch.from_numpy(labels).to(dev, torch.int32),
            train_mask=torch.ones((n,), dtype=torch.bool, device=dev)),)
        i += 1


if __name__ == "__main__":
    main()
