"""Parameter trees of the port: nested dicts, tuples and lists of tensors.

The port's counterpart of the ``jax.tree`` functions it needs.  Leaves come
in the reference's order (dict keys sorted, sequences in index order, as
``jax.tree.leaves`` gives them), and a leaf's path is its dict keys and
sequence indices joined with ``SEP``, as the reference's checkpoints key
them (``src/repro/checkpoint/ckpt.py``).
"""
from __future__ import annotations

__all__ = ["SEP", "tree_map", "tree_map_with_path", "tree_map_with_keys",
           "tree_leaves", "flatten"]

SEP = "§"


def _items(tree):
    """(key, child) pairs of a dict or sequence in the reference's order,
    or None for a leaf."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def tree_map_with_keys(fn, tree, *rest, keys: tuple = ()):
    """``fn(keys, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, as a new tree of its structure, with ``keys`` the tuple of
    dict keys and sequence indices (ints) that leads to the leaf; ``rest``
    share the structure of ``tree`` down to its leaves."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, *(r[k] for r in rest),
                                      keys=keys + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_keys(fn, v, *(r[i] for r in rest),
                                             keys=keys + (i,))
                          for i, v in enumerate(tree))
    return fn(keys, tree, *rest)


def tree_map_with_path(fn, tree, *rest):
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, as a new tree of its structure; ``rest`` share the structure
    of ``tree`` down to its leaves (what lies below is passed to ``fn``)."""
    return tree_map_with_keys(
        lambda keys, *leaves: fn(SEP.join(map(str, keys)), *leaves), tree,
        *rest)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over the leaves of ``tree``."""
    return tree_map_with_keys(lambda _, *leaves: fn(*leaves), tree, *rest)


def flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` in the reference's leaf order."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return out


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return list(flatten(tree).values())
