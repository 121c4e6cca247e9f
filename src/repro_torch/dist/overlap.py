"""Communication/computation overlap: the collective matmul.

Port of ``repro/dist/overlap.py``.  A1 §3.4 overlaps shipping with work:
while a machine serves one request it already has the next on the wire.
The tensor-parallel analogue is the *collective matmul* (Wang et al.,
ASPLOS'23): instead of all-gathering the row-sharded activations and then
running one big matmul, walk the gather as a ``ppermute`` ring and consume
each chunk as it lands.

The JAX functions run inside ``shard_map`` on per-device views.  Here they
run on the lockstep mesh (``dist/mesh.py``): :func:`collective_matmul_ag`
takes the list of every shard's row chunk and weight block, and each step
issues the next hop's ``ppermute`` before it runs this step's chunk
matmuls, in the JAX code's order.  :func:`tp_matmul_ag` splits a
``(B, S, K)`` activation and a ``(K, O)`` weight over the mesh in scope as
the JAX ``shard_map``'s in-specs do, runs the ring and puts ``(B, S, O)``
back together; the LM wires it into its q/k/v and w1/w3 products under
``LMConfig.use_collective_matmul``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import mesh as mesh_mod


def ring_perm(n: int):
    """Send-"up" ppermute ring: index i -> i+1 (mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def collective_matmul_ag(x_shards: list, w_locals: list, axis_name: str, *,
                         mesh=None) -> list:
    """All-gather(x) @ w on a ppermute ring of the N shards along
    ``axis_name`` of ``mesh`` (the mesh in scope by default).

    ``x_shards[s]`` is shard s's (S/N, K) activation rows and
    ``w_locals[s]`` its (K, O/N) weight columns; returns each shard's
    (S, O/N): its output columns for *all* rows, as the unfused
    ``all_gather(x) @ w_local`` gives them, computed as N chunk matmuls."""
    mesh = mesh_mod.scoped(mesh)
    n = mesh.axis_size(axis_name)
    me = mesh_mod.axis_index(mesh, axis_name)
    s = x_shards[0].shape[0]
    perm = ring_perm(n)
    outs = []
    for x, w in zip(x_shards, w_locals):
        dtype = torch.result_type(x, w)
        outs.append(torch.zeros((n * s, w.shape[1]), dtype=dtype,
                                device=x.device))
    chunks = list(x_shards)
    for step in range(n):
        # the next hop first, then this chunk's matmuls; the ring sends
        # "up", so after k hops shard me holds chunk me - k
        nxt = (mesh_mod.ppermute(chunks, mesh, axis_name, perm)
               if step != n - 1 else None)
        for i, (chunk, w, out) in enumerate(zip(chunks, w_locals, outs)):
            src = (me[i] - step) % n
            out[src * s:(src + 1) * s] = (chunk @ w).to(out.dtype)
        chunks = nxt
    return outs


def tp_matmul_ag(x, w, *, axis: str = "model", batch_axes=("pod", "data")):
    """Gather-overlapped tensor-parallel matmul for 3D activations.

    The sequence-parallel TP pattern: ``x (B, S, K)`` arrives split over the
    batch axes on B and over ``axis`` on S, ``w (K, O)`` split over
    ``axis`` by columns; the ring of :func:`collective_matmul_ag` gives
    each shard its columns for every row, and the shards' blocks make up
    ``(B, S, O)``.  The plain ``x @ w`` where no mesh is in scope, ``axis``
    is absent or of size 1, x is not 3D, S does not divide over ``axis``,
    or B and O do not divide over their shards (JAX's conditions): CPU
    unit tests and decode (S = 1) run the reference contraction."""
    mesh = mesh_mod.current()
    if (mesh is None or axis not in mesh.axis_names
            or mesh.axis_size(axis) == 1 or x.dim() != 3
            or x.shape[1] % mesh.axis_size(axis) != 0):
        return x @ w
    n = mesh.axis_size(axis)
    baxes = tuple(a for a in batch_axes if a in mesh.axis_names)
    b_shards = math.prod(mesh.axis_size(a) for a in baxes)
    B, S, K = x.shape
    if B % b_shards != 0 or w.shape[1] % n != 0:
        return x @ w
    b_loc, s_loc, o_loc = B // b_shards, S // n, w.shape[1] // n
    bi = [0] * mesh.size        # each shard's row-major index over baxes
    for a in baxes:
        bi = [b * mesh.axis_size(a) + i
              for b, i in zip(bi, mesh_mod.axis_index(mesh, a))]
    mi = mesh_mod.axis_index(mesh, axis)
    xs = [x[b * b_loc:(b + 1) * b_loc, m * s_loc:(m + 1) * s_loc]
          .reshape(b_loc * s_loc, K).to(dev)
          for b, m, dev in zip(bi, mi, mesh.devices)]
    ws = [w[:, m * o_loc:(m + 1) * o_loc].to(dev)
          for m, dev in zip(mi, mesh.devices)]
    outs = collective_matmul_ag(xs, ws, axis, mesh=mesh)
    # each ring output is chunk-major (src, b, s_loc): put back (b, S);
    # shards that differ only on other axes hold the same block
    blocks = {}
    for b, m, out in zip(bi, mi, outs):
        blocks.setdefault((b, m), out.reshape(n, b_loc, s_loc, o_loc)
                          .transpose(0, 1).reshape(b_loc, S, o_loc)
                          .to(x.device))
    return torch.cat([torch.cat([blocks[(b, m)] for m in range(n)], dim=2)
                      for b in range(b_shards)], dim=0)
