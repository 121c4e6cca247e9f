"""Logical-axis sharding rules: names -> mesh axes -> partition specs.

Port of ``repro/dist/sharding.py``.  Model code annotates tensors with
*logical* axis names ("batch", "heads", "fsdp", ...); a rule table maps
each name to zero or more *mesh* axes.  A parallelism plan is a rule
override dict, scoped with :func:`rules_context` or passed to
:func:`tree_specs`.

A spec is a tuple with one entry a tensor dimension: ``None`` (replicated),
a mesh axis name, or a tuple of mesh axis names (the dimension is split
over their product).  It equals ``tuple(jax.sharding.PartitionSpec)`` of
the JAX package's result.  The resolution contract is JAX's:

  * a logical name maps to ``None``, one mesh axis or a tuple of them;
  * mesh axes absent from the target mesh are dropped, so one plan
    resolves on a ("data", "model") pod and on ("pod", "data", "model");
  * a mesh axis is used at most once a spec (the first dimension wins);
  * an unknown logical name resolves to the mesh axis of the same name
    where there is one, else replicates.

:func:`constrain` resolves a tensor's axes against the mesh in scope (a
``with mesh:`` of :class:`~repro_torch.dist.mesh.ShardMesh`) and checks
them as ``with_sharding_constraint`` does.  One card holds the whole
tensor, so it returns the tensor itself: the specs are what the dry run
(``launch/dryrun.py``) records, and the lockstep mesh's programs split
their tensors explicitly.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Optional

from repro_torch.core.tree import map_leaves
from repro_torch.dist import mesh as mesh_mod

# The repo-wide default plan (Megatron-style TP on 'model', DP/FSDP on
# 'data', outer DP or pipeline on 'pod').  Logical names are the union of
# what models/{transformer,attention,moe,recsys,gnn}.py annotate.
DEFAULT_RULES: dict = {
    "batch":    ("pod", "data"),   # activations: data-parallel dims
    "seq":      None,              # sequence-parallel plans override -> model
    "kv_seq":   "model",           # flash-decoding: KV cache sharded on seq
    "layers":   None,              # stacked layer dim: never sharded
    "embed":    None,              # d_model vectors (ln scales): replicated
    "fsdp":     "data",            # ZeRO-style param/optimizer shard dim
    "heads":    "model",           # q-head tensor parallelism
    "kv_heads": None,              # kv heads < TP degree on assigned archs
    "ff":       "model",           # MLP hidden
    "vocab":    "model",           # embedding rows / logits
    "expert":   "model",           # MoE expert parallelism
    "tensor":   "model",           # generic TP dim (GNN node shards)
}


class _Rules(threading.local):
    def __init__(self):
        self.stack: list[dict] = []


_SCOPED = _Rules()


def _table(rules: Optional[dict] = None) -> dict:
    t = dict(DEFAULT_RULES)
    for d in _SCOPED.stack:
        t.update(d)
    if rules:
        t.update(rules)
    return t


@contextmanager
def rules_context(rules: dict):
    """Scope a rule-override dict: inner contexts win, exits restore."""
    _SCOPED.stack.append(dict(rules))
    try:
        yield
    finally:
        _SCOPED.stack.pop()


def is_axes_leaf(x: Any) -> bool:
    """A logical-axes tuple: all entries are names or None.  A pair of
    axes tuples (Adafactor's factored second moment) is *not* a leaf: it
    resolves to a pair of specs."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def resolve(axes, *, rules: Optional[dict] = None, mesh=None) -> tuple:
    """Logical axes tuple -> spec tuple against ``mesh`` (anything with
    ``axis_names``)."""
    table = _table(rules)
    mesh_axes = tuple(mesh.axis_names) if mesh is not None else ()
    used: set = set()
    parts = []
    for ax in axes:
        if ax is None:
            parts.append(None)
            continue
        if isinstance(ax, str):
            if ax in table:
                val = table[ax]
            else:
                val = ax if ax in mesh_axes else None
        else:           # already a mesh-axis tuple (explicit spec entry)
            val = ax
        if val is None:
            parts.append(None)
            continue
        if isinstance(val, str):
            val = (val,)
        keep = tuple(m for m in val if m in mesh_axes and m not in used)
        used.update(keep)
        parts.append(keep[0] if len(keep) == 1 else (keep or None))
    return tuple(parts)


def tree_specs(tree_axes, *, rules: Optional[dict] = None, mesh=None):
    """Tree of logical-axes tuples -> tree of spec tuples.  ``()`` (a
    scalar) resolves to ``()``; ``None`` leaves pass through."""
    return map_leaves(lambda a: resolve(a, rules=rules, mesh=mesh),
                      tree_axes, is_axes_leaf)


def current_mesh():
    """The mesh in scope (``with mesh:``), else None."""
    return mesh_mod.current()


def constrain(x, axes, *, rules: Optional[dict] = None):
    """Rule-aware sharding constraint: ``x`` itself.  With a mesh in scope
    the axes resolve against it, and a spec longer than ``x``'s rank
    raises, as ``with_sharding_constraint`` does; one card holds the whole
    tensor, so nothing moves.  With no mesh it is the identity outright."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = resolve(axes, rules=rules, mesh=mesh)
    if len(spec) > x.dim():
        raise ValueError(f"constrain: a spec of {len(spec)} dimensions "
                         f"{spec} for a tensor of rank {x.dim()}")
    return x
