"""GPipe-style microbatch pipeline over a named mesh axis.

Port of ``repro/dist/pipeline.py``.  Each shard along ``axis`` owns one
stage's weights (the A1 analogue: each machine owns one region of the
graph and work flows through owners).  Microbatches stream through the
ring: at tick t, stage s computes microbatch t - s and hands its
activation to stage s + 1 with ``ppermute``.  M microbatches over S stages
take M + S - 1 ticks; the bubble is (S - 1) / (M + S - 1).

The JAX function runs inside ``shard_map``; this one runs on the lockstep
mesh (``dist/mesh.py``), every shard's stage at every tick.  All stages
share one activation shape and dtype.
"""
from __future__ import annotations

import torch

from repro_torch.dist import mesh as mesh_mod
from repro_torch.dist.overlap import ring_perm


def pipeline_apply(stage_fn, stage_params: list, x, *, mesh=None, axis: str,
                   n_stages: int, n_microbatches: int) -> list:
    """Run ``x`` through ``n_stages`` pipeline stages along ``axis``.

    Args:
      stage_fn:       (params, h) -> h', shape-preserving
      stage_params:   one entry a shard: that shard's stage weights
      x:              (n_microbatches, *mb_shape), the full input stream
                      (only stage 0 reads it)
      mesh:           the lockstep mesh (the mesh in scope by default)
      axis:           the mesh axis carrying the stages
      n_stages:       pipeline depth; must equal the axis size
      n_microbatches: M, the leading dim of ``x``

    Returns one (n_microbatches, *mb_shape) tensor a shard: on the *last*
    stage the outputs, on earlier stages zeros.  Past M, stage 0 reruns the
    last microbatch (clamped), whose results are never written.
    """
    mesh = mesh_mod.scoped(mesh)
    size = mesh.axis_size(axis)
    if size != n_stages:
        raise ValueError(f"n_stages={n_stages} != |{axis}|={size}")
    M = n_microbatches
    if x.shape[0] != M:
        raise ValueError(f"x leading dim {x.shape[0]} != M={M}")
    stage = mesh_mod.axis_index(mesh, axis)
    # jax.eval_shape: the first stage-0 shard's call on microbatch 0 gives
    # the output's shape and dtype (and is its result at tick 0 when that
    # dtype is x's: stage 0 reads x cast to it)
    first = stage.index(0)
    probe = stage_fn(stage_params[first], x[0].to(mesh.devices[first]))
    if probe.shape != x.shape[1:]:
        raise ValueError(f"stage_fn must preserve shape: "
                         f"{tuple(probe.shape)} != {tuple(x.shape[1:])}")
    dtype = probe.dtype
    perm = ring_perm(n_stages)
    h = [torch.zeros(x.shape[1:], dtype=dtype, device=d)
         for d in mesh.devices]
    out = [torch.zeros((M,) + x.shape[1:], dtype=dtype, device=d)
           for d in mesh.devices]
    for t in range(M + n_stages - 1):
        x_t = x[min(max(t, 0), M - 1)].to(dtype)
        y = [probe if (t, i) == (0, first) and dtype == x.dtype else
             stage_fn(p, x_t.to(d) if st == 0 else hs)
             for i, (p, st, hs, d) in enumerate(zip(
                 stage_params, stage, h, mesh.devices))]
        h = mesh_mod.ppermute(y, mesh, axis, perm)
        # the last stage emits microbatch t - (S - 1) once the fill drains
        o_t = t - (n_stages - 1)
        if o_t >= 0:
            for i, st in enumerate(stage):
                if st == n_stages - 1:
                    out[i][o_t] = y[i]
    return out
