"""Parameter trees of the port: nested dicts, tuples and lists of tensors.

The port's counterpart of the ``jax.tree`` functions it needs.  Leaves come
in the reference's order (dict keys sorted, sequences in index order, as
``jax.tree.leaves`` gives them), and a leaf's path is its dict keys and
sequence indices joined with ``SEP``, as the reference's checkpoints key
them (``src/repro/checkpoint/ckpt.py``).
"""
from __future__ import annotations

__all__ = ["SEP", "tree_map", "tree_map_with_path", "tree_leaves",
           "flatten"]

SEP = "§"


def _items(tree):
    """(key, child) pairs of a dict or sequence in the reference's order,
    or None for a leaf."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def tree_map_with_path(fn, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, as a new tree of its structure; ``rest`` share the structure
    of ``tree`` down to its leaves (what lies below is passed to ``fn``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(
                    fn, v, *(r[k] for r in rest),
                    prefix=f"{prefix}{SEP}{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(
                              fn, v, *(r[i] for r in rest),
                              prefix=f"{prefix}{SEP}{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over the leaves of ``tree``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


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
