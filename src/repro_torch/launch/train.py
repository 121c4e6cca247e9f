"""Training entry point for the model zoo on one device.

Port of ``repro/launch/train.py`` (``run_training``, ``_batch_source``)
for every arch of the port's registry (``configs/registry.py::get``) that
trains: the LM family (dense and MoE), the GNNs (gcn-cora,
graphsage-reddit, meshgraphnet, nequip) and bst:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gcn-cora --steps 20 --device cpu --ckpt-dir /tmp/ckpt

Parameters from the family's ``init_params`` with a seeded
``torch.Generator``, the optimizer of the JAX cell (``pick_opt`` for an
LM, AdamW with f32 moments otherwise), input batches shaped like the
arch's first shape cell (``train_4k``, ``full_graph_sm``, ``train_batch``)
from ``np.random.default_rng`` as the JAX trainer draws them, the
non-finite-loss circuit breaker (a step with a non-finite loss changes
nothing), and checkpoints (``ckpt/manager.py``): with ``ckpt_dir`` the
run resumes from the latest checkpoint there and saves (params, optimizer
state) every ``ckpt_every`` steps.  As in the JAX trainer, a resumed run's
batches start again at ``seed``: no data cursor is saved.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core.backend import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run_training(arch=args.arch, steps=args.steps, reduced=args.reduced,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 device=args.device)


def run_training(arch: str, *, steps: int = 50, reduced: bool = True,
                 ckpt_dir: str = None, ckpt_every: int = 20, seed: int = 0,
                 log_every: int = 10, device=None) -> dict:
    """Programmatic entry point; returns the last step's metrics."""
    spec = registry.get(arch)
    if spec.family == "a1":
        raise KeyError(f"{arch} is a graph store, not a trained arch")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    build = _lm if spec.family == "lm" else _zoo
    step_fn, params, ocfg, batches = build(spec, reduced, gen, seed, dev)
    from repro_torch.optim.optimizers import init_opt_state
    opt_state = init_opt_state(params, ocfg)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        (params, opt_state), manifest = mgr.restore((params, opt_state))
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    metrics = {}
    t0 = time.time()
    for step in range(start_step, steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             *next(batches))
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            print(f"step {step}: non-finite loss, skipping update")
            continue            # circuit breaker: the state was kept
        if step % log_every == 0:
            dt = (time.time() - t0) / max(step - start_step + 1, 1)
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['gnorm']):.3f} "
                  f"({dt*1e3:.0f} ms/step)")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state),
                     meta={"arch": arch, "loss": loss})
    if mgr is not None:
        mgr.wait()
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
    return (step_fn,
            steps.gnn_module(cfg).init_params(cfg, gen, device=dev), ocfg,
            _gnn_batches(cfg, steps.gnn_geometry(cell0, reduced), seed, dev))


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


def _gnn_batches(cfg, geometry, seed, dev):
    """Infinite iterator of 1-tuples of GraphBatch: uniform random graphs
    of the cell's ``geometry`` (nodes, edges, features, graphs) from
    ``default_rng(seed + i)``, drawn as the JAX trainer draws its
    full-batch stand-in for every GNN cell, in its order: features
    ``|N(0, 1)| % 4``, src, dst, then the labels (four classes, or
    ``N(0, 1)`` regression targets: (N, 3) for MGN, a graph's energy for
    NequIP), positions ``N(0, 1)`` for MGN and NequIP, and NequIP's
    ``graph_ids`` (nodes in ``n_graphs`` equal runs); every label
    trained on."""
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.models.gnn.meshgraphnet import MGNConfig
    from repro_torch.models.gnn.nequip import NequIPConfig
    n, e, d_feat, n_graphs = geometry
    mgn, neq = isinstance(cfg, MGNConfig), isinstance(cfg, NequIPConfig)
    label_shape = (n, 3) if mgn else (n_graphs,) if neq else (n,)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)
    i = 0
    while True:
        r = np.random.default_rng(seed + i)
        feat = np.abs(r.normal(size=(n, d_feat))) % 4
        src, dst = r.integers(0, n, e), r.integers(0, n, e)
        labels = (r.normal(size=label_shape) if mgn or neq else
                  r.integers(0, 4, label_shape))
        pos = r.normal(size=(n, 3)) if mgn or neq else None
        gids = (np.minimum(np.arange(n) // max(n // n_graphs, 1),
                           n_graphs - 1) if neq else None)
        yield (GraphBatch(
            node_feat=t(feat, torch.float32),
            edge_src=t(src, torch.int32), edge_dst=t(dst, torch.int32),
            labels=t(labels, torch.float32 if mgn or neq else torch.int32),
            train_mask=torch.ones(label_shape[:1], dtype=torch.bool,
                                  device=dev),
            positions=None if pos is None else t(pos, torch.float32),
            graph_ids=None if gids is None else t(gids, torch.int32),
            n_graphs=n_graphs),)
        i += 1


if __name__ == "__main__":
    main()
