"""Carry parameter trees across from the JAX package.

``params_from_numpy`` takes the reference's parameters as NumPy arrays
(``jax.tree.map(np.asarray, params)``, or a checkpoint's arrays put back into
their tree) and returns the port's tree of tensors: the same dicts and tuples,
each leaf a tensor on ``device``.  ``flatten`` (``repro_torch.tree``) keys
a tree's leaves like the reference's checkpoints
(``src/repro/checkpoint/ckpt.py``: dict keys and tuple indices joined with
``§``), so the two trees can be compared leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import SEP, flatten, tree_map

__all__ = ["params_from_numpy", "flatten", "SEP"]


def params_from_numpy(tree, device="cuda"):
    """The tree with every array leaf copied into a tensor on ``device``."""
    dev = resolve_device(device)

    def conv(leaf):
        # np.array copies: the source may be a read-only view of a JAX buffer
        arr = np.array(leaf)
        if arr.dtype.name == "bfloat16":   # ml_dtypes; exact through float32
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(arr).to(dev)

    return tree_map(conv, tree)
