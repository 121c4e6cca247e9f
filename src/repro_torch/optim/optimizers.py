"""Optimizers: AdamW (float32 or bfloat16 moments) and Adafactor (factored
second moment), with global-norm clipping.

Port of ``repro/optim/optimizers.py``.  Parameters, gradients and states
are trees of tensors (``core/tree.py``) visited in ``jax.tree.flatten``
order.  The JAX functions return new trees; here :func:`opt_update` writes
the parameters and moments in place and :func:`clip_by_global_norm` scales
the gradients in place, so that a full-width update holds no second copy
of the model.  AdamW's elementwise update runs over slices of at most
``CHUNK`` elements along each leaf's first axis (a stacked leaf's layers),
which bounds its float32 temporaries and gives the same values as the
whole-leaf JAX expression; global norms sum the slices' squares.  Adafactor
(selected above 100 B parameters, which no ported config reaches) updates
whole leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import leaves, tree_map

CHUNK = 1 << 25            # elements of a slice of the in-place update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Any = torch.float32    # bf16 halves optimizer memory
    grad_clip: float = 1.0


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    weight_decay: float = 0.0
    min_dim_factored: int = 128         # factor only big matrices
    grad_clip: float = 1.0


@dataclasses.dataclass
class OptState:
    step: torch.Tensor      # int32, ()
    m: Any                  # AdamW first moment; Adafactor: () zeros
    v: Any                  # AdamW second moment; Adafactor: the tensor,
    #                         or (row, column) means for a factored leaf


def _tensors(tree):
    return [t for _, t in leaves(tree)]


def _chunks(t):
    """``t`` as views of at most CHUNK elements along its first axis (one
    view when it is smaller or has fewer than two axes)."""
    if t.dim() < 2 or t.numel() <= CHUNK:
        return (t,)
    return t.split(max(1, CHUNK // (t.numel() // t.shape[0])))


def _is_factored(p, cfg) -> bool:
    return (p.dim() >= 2 and p.shape[-1] >= cfg.min_dim_factored
            and p.shape[-2] >= cfg.min_dim_factored)


def init_opt_state(params, cfg) -> OptState:
    dev = _tensors(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if isinstance(cfg, AdamWConfig):
        def zeros(p):
            return torch.zeros(p.shape, dtype=cfg.state_dtype, device=dev)
        return OptState(step=step, m=tree_map(zeros, params),
                        v=tree_map(zeros, params))
    if not isinstance(cfg, AdafactorConfig):
        raise TypeError(f"unknown optimizer config {cfg!r}")

    def vstate(p):
        if _is_factored(p, cfg):
            return (torch.zeros(p.shape[:-1], device=dev),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], device=dev))
        return torch.zeros(p.shape, device=dev)

    return OptState(step=step,
                    m=tree_map(lambda p: torch.zeros((), device=dev), params),
                    v=tree_map(vstate, params))


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in float32."""
    per_leaf = [sum(torch.sum(torch.square(c.float())) for c in _chunks(x))
                for x in _tensors(tree)]
    return torch.sqrt(torch.sum(torch.stack(per_leaf)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """Scales ``grads`` in place by ``min(1, max_norm / norm)``; returns
    (grads, norm)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    for x in _tensors(grads):
        for c in _chunks(x):
            c.copy_(c.float() * scale)
    return grads, g


@torch.no_grad()
def opt_update(params, grads, state: OptState, cfg, lr_scale=1.0):
    """One optimizer step, in place: the gradients are clipped and the
    parameters and moments overwritten.  Returns (params, new state with
    the next step count, gradient norm before clipping)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    stepf = step.float()
    ps, gs = _tensors(params), _tensors(grads)
    if isinstance(cfg, AdamWConfig):
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        for p, g, m, v in zip(ps, gs, _tensors(state.m), _tensors(state.v)):
            for pc, gc, mc, vc in zip(*map(_chunks, (p, g, m, v))):
                gf = gc.float()
                mf = b1 * mc.float() + (1 - b1) * gf
                vf = b2 * vc.float() + (1 - b2) * gf * gf
                delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
                delta = delta + cfg.weight_decay * pc.float()
                pc.copy_(pc.float() - cfg.lr * lr_scale * delta)
                mc.copy_(mf)
                vc.copy_(vf)
        return params, OptState(step=step, m=state.m, v=state.v), gnorm

    if not isinstance(cfg, AdafactorConfig):
        raise TypeError(f"unknown optimizer config {cfg!r}")
    rho = 1.0 - stepf ** -cfg.decay
    for p, g, v in zip(ps, gs, _tensors(state.v)):
        gf = g.float()
        g2 = gf * gf + cfg.eps
        if isinstance(v, tuple):
            vr, vc = v
            vr.copy_(rho * vr + (1 - rho) * torch.mean(g2, dim=-1))
            vc.copy_(rho * vc + (1 - rho) * torch.mean(g2, dim=-2))
            denom = torch.clamp(
                torch.mean(vr, dim=-1, keepdim=True)[..., None], min=cfg.eps)
            vhat = vr[..., None] * vc[..., None, :] / denom
        else:
            v.copy_(rho * v + (1 - rho) * g2)
            vhat = v
        update = gf * torch.rsqrt(vhat + cfg.eps)
        # relative step-size clipping (Adafactor's d=1.0)
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        pf = p.float()
        p.copy_(pf - cfg.lr * lr_scale * update
                - cfg.lr * lr_scale * cfg.weight_decay * pf)
    return params, OptState(step=step, m=state.m, v=state.v), gnorm
