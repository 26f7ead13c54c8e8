"""Global-norm gradient clipping (the port of ``src/repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.parallel.shards import is_dtensor, sum_of_squares
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """float32 L2 norm over every leaf, summed leaf by leaf in the
    reference's order.  Over DTensors each rank sums its shards and one
    all-reduce adds the ranks' sums (``shards.sum_of_squares``), so the
    order differs from the plain sum's and the norm agrees with it to
    float32 rounding."""
    leaves = tree_leaves(tree)
    if any(is_dtensor(x) for x in leaves):
        return torch.sqrt(sum_of_squares(leaves))
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, each in
    its own dtype; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
