"""Parameter trees: nested dicts and lists of tensors, as JAX pytrees.

The port keeps the JAX package's parameter and optimizer-state layouts as
plain containers.  Dict keys are visited in sorted order and lists in
order, as ``jax.tree.flatten`` does; anything else (a tensor, or a tuple
such as Adafactor's factored second moment) is a leaf.
"""
from __future__ import annotations


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
