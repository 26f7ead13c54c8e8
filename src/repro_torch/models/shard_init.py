"""Random weights drawn shard by shard, so that each rank of a mesh makes
only its own shard, and one process can make the whole tree with the same
values.

``T.init_params`` draws every leaf whole from one generator: a 70-93 GB
tree cannot be drawn on one card and then split.  Here every leaf is cut
into the blocks that ``param_specs`` splits it into on a mesh of
``mesh_shape`` (each dim into as many equal pieces as the mesh axes it is
split over have ranks; a stacked layer leaf also by layer), and each block
is drawn from a generator of its own, seeded by the seed, the leaf's path,
the layer and the block's index: ``init_shards`` draws this rank's blocks
(its shard) and ``init_whole`` all of them, put together.  A block's values
do not depend on the layer count, so a 2-layer tree's layers are the first
two of a 64-layer tree's.  Each leaf keeps ``init_params``'s distribution
(``N(0, 1)`` times its scale, drawn in float32 and cast; norm scales ones),
but not its values.

Dense and MoE attention layers are covered (the archs whose production
cells need a mesh); a layout that pads or duplicates heads (``AttnDims``)
is refused, as a block of a duplicated head would not equal its copy.
"""
from __future__ import annotations

import hashlib
import itertools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.models.common import init_scale
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import _DTYPES
from repro_torch.parallel.sharding import (mesh_shape_dict, mesh_shape_size,
                                           param_specs, placements,
                                           zero1_specs)
from repro_torch.parallel.shards import local_shape, replicate_like
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_keys

__all__ = ["init_shards", "init_whole", "zero1_axes", "zero1_state"]


def block_seed(seed: int, path: str, layer: int, block: tuple) -> int:
    """The generator seed of one block: 63 bits of a SHA-256 of the seed,
    the leaf's path, its layer (-1 for a leaf outside the layer stack) and
    the block's index."""
    text = f"{seed}|{path}|{layer}|{','.join(map(str, block))}".encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _scale(cfg, names: tuple, shape: tuple) -> float | None:
    """``init_params``' scale of a leaf (``shape`` without the layer dim,
    its heads unpadded: ``_check_heads``), from ``common.init_scale``; None
    for a norm's scale (ones)."""
    if names[-1] == "scale":
        return None
    try:
        return init_scale(names[-1], shape[-2] if len(shape) >= 2 else None)
    except ValueError:
        raise ValueError(f"no shard-seeded rule for the leaf "
                         f"{'/'.join(names)} of {cfg.name}") from None


def _check_heads(cfg) -> None:
    dims = T._dims(cfg)
    if any(spec.mixer == "attn" for spec in cfg.pattern) and (
            dims.n_q_phys != dims.n_q or dims.n_kv_phys != dims.n_kv):
        raise ValueError(f"{cfg.name} at tp {cfg.tp} pads or duplicates "
                         f"heads ({dims.n_q}/{dims.n_kv} -> {dims.n_q_phys}/"
                         f"{dims.n_kv_phys}): not drawn shard by shard")


def _leaves(cfg, mesh_shape: dict, dtype):
    """(meta tree, spec tree) of ``cfg``'s weights on ``mesh_shape``."""
    _check_heads(cfg)
    meta = T.init_params(cfg, dtype=dtype, device="meta")
    return meta, param_specs(cfg, meta, mesh_shape)


def _pieces(spec, ndim: int, mesh_shape: dict) -> tuple:
    """How many blocks each of a leaf's ``ndim`` dims is cut into."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(1 if ax is None else mesh_shape_size(ax, mesh_shape)
                 for ax in spec)


def _draw(seed: int, names: tuple, layer: int, block: tuple, shape, scale,
          dtype, dev) -> torch.Tensor:
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(
        block_seed(seed, "/".join(names), layer, block))
    x = torch.randn(shape, dtype=torch.float32, device=dev, generator=g)
    return (x * scale).to(dtype)


def _fill(cfg, seed: int, names: tuple, leaf, spec, mesh_shape: dict,
          blocks, dev) -> torch.Tensor:
    """The blocks ``blocks`` (an index per dim, the layer dim excluded) of
    a leaf, put together into one tensor (its shard, or the whole)."""
    stacked = names[0] == "blocks"
    shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
    pieces = _pieces(tuple(spec)[1:] if stacked else spec, len(shape),
                     mesh_shape)
    block_shape = tuple(n // p for n, p in zip(shape, pieces))
    scale = _scale(cfg, names, shape)
    lo = [min(ix) for ix in zip(*blocks)] if shape else []
    hi = [max(ix) + 1 for ix in zip(*blocks)] if shape else []
    out_shape = tuple((h - l) * b for l, h, b in zip(lo, hi, block_shape))
    layers = range(leaf.shape[0]) if stacked else (-1,)
    out = torch.empty(((len(layers),) if stacked else ()) + out_shape,
                      dtype=leaf.dtype, device=dev)
    for layer in layers:
        dst = out[layer] if stacked else out
        for block in blocks:
            part = _draw(seed, names, layer, block, block_shape, scale,
                         leaf.dtype, dev)
            idx = tuple(slice((i - l) * b, (i - l + 1) * b)
                        for i, l, b in zip(block, lo, block_shape))
            dst[idx] = part
    return out


def init_whole(cfg, mesh_shape: dict, seed: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """The whole tree whose shards ``init_shards`` draws on a mesh of
    ``mesh_shape`` (axis name -> size), as plain tensors on ``device``."""
    dev = resolve_device(device)
    meta, specs = _leaves(cfg, mesh_shape, dtype)

    def one(keys, leaf, spec):
        names = tuple(str(k) for k in keys)
        shape = leaf.shape[1:] if names[0] == "blocks" else leaf.shape
        spec_t = tuple(spec)[1:] if names[0] == "blocks" else spec
        blocks = list(itertools.product(*(
            range(p) for p in _pieces(spec_t, len(shape), mesh_shape))))
        return _fill(cfg, seed, names, leaf, spec, mesh_shape, blocks, dev)

    return tree_map_with_keys(one, meta, specs)


def init_shards(cfg, mesh, seed: int, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """This rank's shard of every leaf of ``cfg``'s weights, drawn on
    ``device`` block by block (nothing else is drawn), as DTensors laid out
    by ``param_specs`` on ``mesh``."""
    dev = resolve_device(device)
    msd = mesh_shape_dict(mesh)
    meta, specs = _leaves(cfg, msd, dtype)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

    def one(keys, leaf, spec):
        names = tuple(str(k) for k in keys)
        stacked = names[0] == "blocks"
        spec_t = tuple(spec)[1:] if stacked else tuple(spec)
        ndim = leaf.dim() - stacked
        block = []
        for ax in spec_t + (None,) * (ndim - len(spec_t)):
            i = 0
            for a in () if ax is None else (
                    (ax,) if isinstance(ax, str) else ax):
                i = i * msd[a] + coord[a]
            block.append(i)
        local = _fill(cfg, seed, names, leaf, spec, msd, [tuple(block)], dev)
        return DTensor.from_local(
            local, mesh, placements(spec, mesh), run_check=False,
            shape=leaf.shape,
            stride=torch.empty(leaf.shape, device="meta").stride())

    return tree_map_with_keys(one, meta, specs)


def zero1_axes(cfg) -> tuple:
    """The mesh axes ZeRO-1 shards the moments over: 'data', and 'model'
    too in the ``dp`` and ``fsdp2d`` layouts (the reference's rule,
    ``launch/dryrun.py:_trace_cell``)."""
    return ("data", "model") if cfg.layout in ("dp", "fsdp2d") \
        else ("data",)


def zero1_state(cfg, params, mesh, opt_cfg) -> dict:
    """AdamW's zero state for the DTensor weights ``params`` (laid out by
    ``param_specs``): each moment at ``opt_cfg.moment_dtype`` laid out by
    ``zero1_specs`` over ``zero1_axes(cfg)``, each rank allocating its own
    shard alone; the step counter an int32 zero, replicated."""
    msd = mesh_shape_dict(mesh)
    specs = zero1_specs(param_specs(cfg, params, msd), params, msd,
                        axes=zero1_axes(cfg))
    dt = _DTYPES[opt_cfg.moment_dtype]
    dev = tree_leaves(params)[0].to_local().device

    def zeros(p, spec):
        pl = placements(spec, mesh)
        return DTensor.from_local(
            torch.zeros(local_shape(p.shape, mesh, pl), dtype=dt, device=dev),
            mesh, pl, run_check=False, shape=p.shape,
            stride=torch.empty(p.shape, device="meta").stride())

    first = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params, specs),
            "v": tree_map(zeros, params, specs),
            "step": replicate_like(torch.zeros((), dtype=torch.int32,
                                               device=dev), first)}
