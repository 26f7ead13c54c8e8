"""Distributed-optimization collectives on ``torch.distributed``.

The port of ``src/repro/parallel/collectives.py``; each function works on a
rank's local tensors, as the reference's run inside ``shard_map``, and takes
its process groups from the caller (gloo on the CPU, NCCL on the card).

* ``int8_all_reduce`` — error-bounded quantized all-reduce: per-chunk max-scaling to
  int8, integer sum (exact), dequantize.  Used for the CROSS-POD leg of gradient
  reduction, where the link between pods (not the one inside a pod) is the
  bottleneck: 4x fewer bytes for <0.4 % relative error on gradient-scale tensors.

* ``hierarchical_grad_reduce`` — two-level reduction: full-precision mean over
  the intra-pod 'data' group, optionally-compressed mean over the 'pod' group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

__all__ = ["int8_all_reduce", "hierarchical_grad_reduce"]


def _quantize(x, chunk=256):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % chunk
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, chunk).float()
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, x.shape, pad


def _dequantize(q, scale, shape, pad, dtype):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def int8_all_reduce(x: torch.Tensor, group=None, *, mean: bool = True,
                    chunk: int = 256) -> torch.Tensor:
    """Quantized all-reduce of a rank's ``x`` over ``group`` (a process
    group; None is the default group).

    Each participant quantizes its contribution to int8 with per-chunk scales;
    the int32 sum of mantissas is exact; scales are summed for a shared dequant
    level (upper bound of the true max-scale — conservative, error stays
    bounded).
    """
    q, scale, shape, pad = _quantize(x, chunk)
    n = dist.get_world_size(group)
    # shared scale = sum of per-rank scales (>= true max): each rank's mantissa
    # re-expressed at the shared scale stays within +-127, so the integer sum
    # cannot overflow or clip
    scale_sum = scale.clone()
    dist.all_reduce(scale_sum, op=dist.ReduceOp.SUM, group=group)
    requant = torch.clamp(torch.round(q.float() * (scale / scale_sum)),
                          -127, 127).to(torch.int32)
    dist.all_reduce(requant, op=dist.ReduceOp.SUM, group=group)
    out = _dequantize(requant, scale_sum, shape, pad, x.dtype)
    return out / n if mean else out


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)


def hierarchical_grad_reduce(grads, mesh, *, compress_cross_pod: bool = True):
    """Mean-reduce a tree of a rank's gradients over the data-parallel axes
    of ``mesh`` (a ``DeviceMesh``): float over 'data', int8 over 'pod'.

    Returns the gradients averaged over every data-parallel participant.
    """
    axis_names = mesh.mesh_dim_names

    def reduce_one(g):
        if "data" in axis_names:
            g = _mean(g, mesh.get_group("data"))
        if "pod" in axis_names:
            if compress_cross_pod:
                g = int8_all_reduce(g, mesh.get_group("pod"), mean=True)
            else:
                g = _mean(g, mesh.get_group("pod"))
        return g

    return tree_map(reduce_one, grads)
