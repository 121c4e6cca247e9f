"""Parameter trees: nested dicts and lists of tensors, as JAX pytrees.

The port keeps the JAX package's parameter and optimizer-state layouts as
plain containers.  Dict keys are visited in sorted order and lists in
order, as ``jax.tree.flatten`` does; anything else (a tensor, or a tuple
such as Adafactor's factored second moment) is a leaf.  :func:`map_leaves`
and :func:`walk_leaves` also open tuples and dataclasses, with the leaf
test the caller gives (tensors by default).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def leaves(tree):
    """(path, leaf) in ``jax.tree.flatten`` order.  ``path`` is a tuple of
    keys and indices."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            for path, leaf in leaves(tree[key]):
                yield (key, *path), leaf
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            for path, leaf in leaves(sub):
                yield (i, *path), leaf
    else:
        yield (), tree


def set_path(tree, path, value) -> None:
    """``tree[path[0]][path[1]]... = value``."""
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def tree_map(fn, tree, *rest):
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and the matching
    leaves of ``rest``, in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def map_leaves(fn, tree, is_leaf=_is_tensor):
    """``fn`` over the leaves of ``tree`` in a tree of the same structure.
    Unlike :func:`tree_map`, tuples and dataclasses are containers too:
    a step's arguments (``GraphBatch``, ``OptState``) and their spec
    trees.  What is neither a leaf nor a container (a dataclass's int)
    passes through."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, is_leaf) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name), is_leaf)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def walk_leaves(tree, is_leaf=_is_tensor):
    """(path, leaf) over the leaves :func:`map_leaves` visits, dict keys in
    sorted order; a dataclass's key is its field's name."""
    if is_leaf(tree):
        yield (), tree
        return
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        return
    for key, sub in items:
        for path, leaf in walk_leaves(sub, is_leaf):
            yield (key, *path), leaf


def get_path(tree, path):
    """The subtree at ``path`` (as :func:`leaves` or :func:`walk_leaves`
    give it): ``tree[path[0]][path[1]]...``, a field by name where the
    node is a dataclass."""
    for key in path:
        tree = getattr(tree, key) if dataclasses.is_dataclass(tree) \
            else tree[key]
    return tree


def meta_tree(shapes, dtype):
    """A tree of shape tuples as ``meta`` tensors of ``dtype``: the dry
    run's ``ShapeDtypeStruct``s (a shape and a dtype, no allocation)."""
    return tree_map(lambda s: torch.empty(s, dtype=dtype, device="meta"),
                    shapes)


def _to_tensor(a, shape, dtype, device) -> torch.Tensor:
    """A copy of the numpy array ``a`` (ml_dtypes bfloat16 included, as
    ``jax.device_get`` gives it) as a ``dtype`` tensor on ``device``;
    raises unless its shape is ``shape``."""
    a = np.ascontiguousarray(np.asarray(a))
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"a leaf of shape {a.shape} where the config has "
                         f"{tuple(shape)}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype, copy=True)


def copy_from_numpy(shapes, tree, dtype, device):
    """A param tree from ``tree``, a JAX param tree held as numpy arrays:
    each leaf of ``shapes`` (a tree of shape tuples) becomes a copy of the
    array at the same path, cast to ``dtype`` on ``device``.  Copies, never
    views: training updates the params in place, and must not write into
    the caller's arrays."""
    out = tree_map(lambda s: None, shapes)
    for path, shape in leaves(shapes):
        set_path(out, path, _to_tensor(get_path(tree, path), shape, dtype,
                                       device))
    return out


def value_and_grad(loss_fn, params, *args, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a param tree:
    ((loss, metrics), grads) of ``loss_fn(params, *args, **kwargs)``,
    grads a tree laid out like ``params``.  The gradient is taken with
    respect to detached aliases of the leaves (no copy, and the caller's
    tensors are not marked); the loss and metrics come back detached.  A
    leaf the loss does not reach (NequIP's last-layer l > 0 mixes) gets a
    zero gradient, as in JAX."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    paths, flat = zip(*leaves(alias))
    with torch.enable_grad():
        loss, metrics = loss_fn(alias, *args, **kwargs)
        gs = torch.autograd.grad(loss, flat, materialize_grads=True)
    grads = tree_map(lambda t: None, params)
    for path, g in zip(paths, gs):
        set_path(grads, path, g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads
