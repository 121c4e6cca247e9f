"""Mixture-of-Experts layer: sort-based token dispatch (GShard semantics).

Port of ``repro/models/moe.py``: route -> top-k -> sort by expert -> rank
within expert -> capacity clip -> scatter tokens into a dense (E, C, D)
buffer -> per-expert SwiGLU -> gather back -> weighted combine.  Tokens
past an expert's capacity are dropped (they pass through the residual
stream untouched).  ``groups > 1`` dispatches per token group (GShard's G
axis), with the capacity per group.

The JAX module has no Pallas kernel: its products are XLA einsums, and so
the port's are batched matmuls.  Its ``constrain`` calls, which place the
groups and experts on a mesh, stand at the same points here
(``dist/sharding.py``), on the port's (E, G, C, D) expert buffer with the
axes in that order.  Where the JAX code
differs from what PyTorch gives by default, the port follows JAX:

  * ``jax.lax.top_k`` puts the lower expert first among equal
    probabilities; the port takes a stable descending sort;
  * a dropped (token, expert) pair scatters to the buffer's one spare row,
    which is cut off (JAX's ``mode="drop"`` of the out-of-range slot);
  * the expert products of bf16 operands are float32 (JAX's
    ``preferred_element_type``): bf16 operands with a float32 output on a
    GPU, operands cast to float32 on the CPU (:func:`_bmm_f32`);
  * the combine adds in float32 (``index_add``: on a GPU with atomics, so
    its order, and the result's last bits, may vary between runs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(_round_up(c, 8), 8)


def _bmm_f32(a, b):
    """``a @ b`` batched, float32 products summed in float32 (JAX's
    ``preferred_element_type=float32``).  Float32 operands multiply as they
    are; bf16 ones keep their dtype with a float32 output on a GPU
    (:class:`_BmmF32`) and are cast to float32 on the CPU, which has no
    such matmul."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    return _BmmF32.apply(a, b)


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=float32)``, which PyTorch gives no
    derivative.  The backward is the CPU route's: the float32 cotangent
    times the other operand in float32, cast to each operand's dtype
    (JAX's transpose of the dot: a float32 product, then the operand's
    dtype)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _route(xf, router_w, top_k: int):
    """(probs, gate, eidx) of float32 tokens ``xf`` (..., D): softmax of the
    router logits, the top ``top_k`` (ties to the lower expert, as
    ``jax.lax.top_k``) and their gates normalised to sum to one."""
    probs = torch.softmax(xf @ router_w.float(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    eidx = order[..., :top_k]
    gate = torch.gather(probs, -1, eidx)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, eidx


def _aux_loss(probs, eidx, E: int):
    """Switch load-balance loss: E * sum(mean prob x first-choice share)."""
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(eidx[..., 0].reshape(-1), E).float().mean(0)
    return E * torch.sum(me * ce)


def _dispatch(eidx, C: int):
    """Sort-based dispatch of each group's (token, k) pairs, ``eidx`` (G,
    Tg, k): (perm, e_s, t_s, rank, keep), each (G, Tg * k).  The pairs
    sorted by (expert, token) (a stable sort of the experts, the pairs
    being in token order): ``perm`` their places before the sort, ``e_s``
    their experts, ``t_s`` their tokens, ``rank`` their place in the
    expert's run and ``keep`` rank < C."""
    G, Tg, k = eidx.shape
    e_s, perm = torch.sort(eidx.reshape(G, Tg * k).int(), dim=-1,
                           stable=True)
    run_start = torch.searchsorted(e_s, e_s, side="left")
    rank = torch.arange(Tg * k, device=eidx.device) - run_start
    return perm, e_s.long(), perm // k, rank, rank < C


def _experts(xe, we1, we3, we2, dtype):
    """SwiGLU of each expert over its rows, ``xe`` (E, N, D) -> (E, N, D)
    float32; the hidden is cast to ``dtype`` before ``we2``, as in JAX."""
    h = _bmm_f32(xe, we1)
    u = _bmm_f32(xe, we3)
    h = F.silu(h) * u
    return _bmm_f32(h.to(dtype), we2)


def moe_ffn(x, router_w, we1, we3, we2, *, top_k: int,
            capacity_factor: float = 1.25, dtype=None, groups: int = 0):
    """x: (T, D) tokens; router_w: (D, E); we*: (E, D, F) / (E, F, D).

    Returns the (T, D) output in ``x.dtype`` and {"aux_loss",
    "drop_frac"} (float32 scalars).  ``groups > 1`` with T a multiple of it
    dispatches per group of T / groups tokens (:func:`_moe_ffn_grouped`);
    otherwise all T tokens dispatch as one group, which is the JAX
    package's global dispatch."""
    G = groups if groups and groups > 1 and x.shape[0] % groups == 0 else 1
    return _moe_ffn_grouped(x, router_w, we1, we3, we2, top_k=top_k,
                            capacity_factor=capacity_factor, groups=G)


def _moe_ffn_grouped(x, router_w, we1, we3, we2, *, top_k: int,
                     capacity_factor: float, groups: int):
    """Group-local dispatch of G = ``groups`` groups of T / G tokens, each
    with its own capacity C.  The expert buffer is (E, G * C, D): group g's
    C rows of expert e follow group g - 1's, so one matmul an expert serves
    every group, and one spare row past the end takes the dropped pairs."""
    T, D = x.shape
    G, E = groups, router_w.shape[-1]
    Tg = T // G
    C = expert_capacity(Tg, E, top_k, capacity_factor)
    xg = constrain(x.reshape(G, Tg, D), ("batch", None, None))
    probs, gate, eidx = _route(xg.float(), router_w, top_k)
    aux_loss = _aux_loss(probs, eidx, E)

    perm, e_s, t_s, rank, keep = _dispatch(eidx, C)
    g_s = torch.gather(gate.reshape(G, Tg * top_k), 1, perm)
    grp = torch.arange(G, device=x.device)[:, None]
    tok = (t_s + grp * Tg).reshape(-1)
    base = grp * C + rank
    row = torch.where(keep, e_s * (G * C) + base, E * G * C).reshape(-1)
    xe = x.new_zeros((E * G * C + 1, D)).index_put((row,), x[tok])
    constrain(xe[:-1].view(E, G, C, D), ("expert", "batch", None, None))
    ye = _experts(xe[:-1].view(E, G * C, D), we1, we3, we2, x.dtype)
    constrain(ye.view(E, G, C, D), ("expert", "batch", None, None))
    # a dropped pair reads its group's last row of the last expert (JAX's
    # slot clamped to E * C - 1) with weight 0
    last = ((E - 1) * G + grp) * C + C - 1
    row_c = torch.where(keep, e_s * (G * C) + base, last).reshape(-1)
    w = torch.where(keep, g_s, 0.0).reshape(-1, 1)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device) \
        .index_add(0, tok, ye.view(E * G * C, D)[row_c] * w)
    drop_frac = 1.0 - keep.float().mean()
    return y.to(x.dtype), {"aux_loss": aux_loss, "drop_frac": drop_frac}
