"""Training entry point for the LM family on one device.

Port of ``repro/launch/train.py`` (``run_training``, ``_batch_source``) for
``family == "lm"``:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-3-4b --steps 20 --device cpu

Parameters from ``init_params`` with a seeded ``torch.Generator``, the
optimizer that ``pick_opt`` chooses, uniform token batches from
``np.random.default_rng(seed)`` shaped like the arch's first shape cell
(``train_4k``), and the non-finite-loss circuit breaker (a step with a
non-finite loss changes nothing).  The GNN and recsys families and
checkpoints (``ckpt/manager.py``) come with ROADMAP queue 1 item 15d.
"""
from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch

from repro_torch.core.backend import resolve_device

ZOO_ITEM = "ROADMAP queue 1 item 15d (the GNN and recsys zoo, ckpt/manager.py)"
# the GNN and recsys arch ids that item 15d ports
ZOO_ARCHS = ("gcn-cora", "graphsage-reddit", "meshgraphnet", "nequip", "bst")
# the LM configs the port has (repro_torch/configs)
LM_CONFIGS = {"h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b"}


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
    from repro_torch.configs.registry import cell
    from repro_torch.launch.steps import (lm_train_step, pick_opt,
                                          train_geometry)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import init_opt_state

    if arch in ZOO_ARCHS:
        raise NotImplementedError(
            f"training {arch} is not ported yet: {ZOO_ITEM}")
    if arch not in LM_CONFIGS:
        raise KeyError(f"no ported config for arch {arch!r}")
    if ckpt_dir is not None:
        raise NotImplementedError(
            f"checkpoints (ckpt_dir) are not ported yet: {ZOO_ITEM}")
    dev = resolve_device(device)
    conf = importlib.import_module(LM_CONFIGS[arch])
    cfg = conf.REDUCED if reduced else conf.FULL
    geo = train_geometry(cell(conf.SHAPES, conf.SHAPES[0].shape_id),
                         reduced=reduced)

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    ocfg = pick_opt(cfg.n_params())
    opt_state = init_opt_state(params, ocfg)
    batches = _batch_source(cfg, geo, seed, dev)
    metrics = {}
    t0 = time.time()
    for step in range(steps):
        tokens, targets = next(batches)
        params, opt_state, metrics = lm_train_step(
            params, opt_state, tokens, targets, cfg, ocfg)
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


def _batch_source(cfg, geometry, seed, dev):
    """Infinite iterator of (tokens, targets), each (accum, micro-batch,
    seq) int32 on ``dev``: uniform token ids, targets shifted by one."""
    accum, mb, S = geometry
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (accum, mb, S + 1))
                                .astype(np.int32))
        yield (toks[..., :-1].contiguous().to(dev),
               toks[..., 1:].contiguous().to(dev))


if __name__ == "__main__":
    main()
