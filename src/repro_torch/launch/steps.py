"""The LM training step on one device.

Port of the LM train branch of ``repro/launch/steps.py`` (``pick_opt``,
the train cell's geometry and ``train_step``).  The JAX cell is a jitted
step over a device mesh with sharded parameters, optimizer state and
gradient accumulator; here one device holds them all, so there is no
sharding, and the step updates the parameters and moments in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, set_path, tree_map
from repro_torch.models import transformer as T
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
