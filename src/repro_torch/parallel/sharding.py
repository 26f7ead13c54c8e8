"""Layout rules for params / batches / caches / moments, and their DTensors.

Copied from ``src/repro/parallel/sharding.py``: the rules are plain Python
over shapes, so every spec equals the reference's.  The port's spec type is
its own ``PartitionSpec``, a tuple (``tuple(spec)`` compares with
``tuple(jax P)``), and a leaf's path names are the reference's
(``_path_names``: dict keys, and ``"[i]"`` for a sequence index).

Layout summary (mesh axes: optional 'pod' [DP across pods], 'data' [DP/FSDP/ZeRO],
'model' [TP]):

  * attention: q/k/v projections column-sharded over 'model' (head dim), out
    projection row-sharded; head-count divisibility handled at init by
    padding/duplication (models/attention.py).
  * MLP / MoE experts: hidden (ff) dim over 'model'; MoE capacity dim over 'data'
    (dispatch all-to-all = EP traffic).
  * Mamba: head-aligned outputs (z/x/dt, conv-x, A/dt/D/norm, out_proj) over
    'model'; head-shared B/C projections replicated.
  * embeddings/lm_head: vocab over 'model' when divisible, else feature dim.
  * fsdp=True (jamba-398B): the complementary dim of every big matrix is
    additionally sharded over 'data' (storage; GSPMD all-gathers per layer).
  * ZeRO-1: adam moments get 'data' inserted on the first free divisible dim.

Every rule validates divisibility against the actual shape and falls back to
replication on that dim — specs always compile.

The torch side: ``placements`` turns a spec into one DTensor placement per
mesh dim, and ``distribute_tree`` lays a tree of tensors out as DTensors on a
``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import tree_map, tree_map_with_keys

__all__ = ["PartitionSpec", "P", "param_specs", "batch_specs", "cache_specs",
           "zero1_specs", "validate_divisibility", "mesh_shape_size",
           "mesh_shape_dict", "placements", "distribute_tree"]


class PartitionSpec(tuple):
    """One entry per leading tensor dim: None (replicated), a mesh axis name,
    or a tuple of names (the dim split over all of them, the first
    outermost).  Trailing dims not named are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _fits(shape, dim, axes, mesh_shape) -> bool:
    if axes is None:
        return True
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    size = int(np.prod([mesh_shape[a] for a in names]))
    return shape[dim] % size == 0


def _mk(shape, mesh_shape, *dims):
    """Build P(...) validating divisibility; non-divisible dims replicate."""
    out = []
    for i, ax in enumerate(dims):
        if ax is not None and _fits(shape, i, ax, mesh_shape) and \
                (mesh_shape_size(ax, mesh_shape) > 1):
            out.append(ax)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def mesh_shape_size(ax, mesh_shape) -> int:
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    return int(np.prod([mesh_shape.get(a, 1) for a in names]))


def mesh_shape_dict(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh``, the rules' ``mesh_shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _leaf_rule(path_names, shape, mesh_shape, fsdp_ax, expert_ax=None):
    """Spec for one param leaf (WITHOUT the stacked-repeats dim)."""
    name = path_names[-1]
    ctx = path_names[-2] if len(path_names) >= 2 else ""

    if name == "table":  # embedding
        # never vocab-sharded: with an FSDP axis the table is (data,
        # model)-sharded; otherwise it is replicated
        if len(shape) == 3:   # codebooks (K, V, d)
            return _mk(shape, mesh_shape, None, fsdp_ax, "model") \
                if fsdp_ax else P()
        return _mk(shape, mesh_shape, fsdp_ax, "model") if fsdp_ax else P()
    if name == "lm_head":
        if len(shape) == 3:   # (K, d, V)
            return _mk(shape, mesh_shape, None, fsdp_ax, "model")
        if _fits(shape, 1, "model", mesh_shape):
            return _mk(shape, mesh_shape, fsdp_ax, "model")
        return _mk(shape, mesh_shape, "model", fsdp_ax)
    if name == "patch_proj":
        return P()
    if name == "router":
        return P()

    if ctx == "attn":
        if name in ("wq", "wk", "wv"):
            return _mk(shape, mesh_shape, fsdp_ax, "model")
        if name == "wo":
            return _mk(shape, mesh_shape, "model", fsdp_ax)
        if name in ("bq", "bk", "bv"):
            return _mk(shape, mesh_shape, "model")

    if ctx == "moe" and len(shape) == 3:  # experts (E, d, ff) / (E, ff, d)
        e_ax = expert_ax if (expert_ax
                             and shape[0] % mesh_shape.get(expert_ax, 1) == 0) \
            else None
        if name in ("wi", "wg"):
            return _mk(shape, mesh_shape, e_ax, None if e_ax else fsdp_ax,
                       "model")
        if name == "wo":
            return _mk(shape, mesh_shape, e_ax, "model",
                       None if e_ax else fsdp_ax)

    if ctx in ("mlp", "shared"):
        if name in ("wi", "wg"):
            return _mk(shape, mesh_shape, fsdp_ax, "model")
        if name == "wo":
            return _mk(shape, mesh_shape, "model", fsdp_ax)

    # mamba leaves
    if name in ("wz", "wx", "wdt"):
        return _mk(shape, mesh_shape, fsdp_ax, "model")
    if name in ("wb", "wc"):
        return _mk(shape, mesh_shape, fsdp_ax, None)
    if name == "conv_wx":
        return _mk(shape, mesh_shape, None, "model")
    if name == "conv_bx":
        return _mk(shape, mesh_shape, "model")
    if name in ("conv_wbc", "conv_bbc"):
        return P()
    if name in ("a_log", "dt_bias", "d_skip", "norm_scale"):
        return _mk(shape, mesh_shape, "model")
    if name == "out_proj":
        return _mk(shape, mesh_shape, "model", fsdp_ax)

    if name == "scale":  # layer norms
        return P()
    return P()  # safe default: replicate


def _path_names(keys) -> tuple:
    """The reference's path names of a leaf: dict keys as strings, a
    sequence index ``i`` as ``"[i]"``."""
    return tuple(f"[{k}]" if isinstance(k, int) else str(k) for k in keys)


def _shape(leaf) -> tuple:
    """A tensor's shape; () for a Python scalar (the cache's ``pos``)."""
    return tuple(getattr(leaf, "shape", ()))


def param_specs(cfg, params_or_shapes, mesh_shape: dict) -> Any:
    """PartitionSpec tree mirroring the param tree.

    ``params_or_shapes``: the params tree (tensors, meta tensors included).
    ``mesh_shape``: e.g. {'data': 16, 'model': 16} or {'pod':2,'data':16,'model':16}.
    Layouts (cfg.layout): 'tp' (Megatron), 'dp' (replicated params),
    'fsdp2d' (params sharded over data AND model).
    """
    if cfg.layout == "dp":
        return tree_map(lambda _: P(), params_or_shapes)
    fsdp_ax = "data" if (cfg.fsdp or cfg.layout == "fsdp2d") else None
    expert_ax = cfg.moe.expert_axis if cfg.moe is not None else None

    def rule(keys, leaf):
        names = _path_names(keys)
        shape = _shape(leaf)
        in_blocks = names and names[0] == "blocks"
        if in_blocks:
            spec = _leaf_rule(names, shape[1:], mesh_shape, fsdp_ax, expert_ax)
            return P(None, *spec)  # leading stacked-repeats dim
        return _leaf_rule(names, shape, mesh_shape, fsdp_ax, expert_ax)

    return tree_map_with_keys(rule, params_or_shapes)


def _dp_axes(mesh_shape, layout: str = "tp"):
    names = ("pod", "data", "model") if layout in ("dp", "fsdp2d") \
        else ("pod", "data")
    axes = tuple(a for a in names if mesh_shape.get(a, 1) > 1)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _batch_dim_spec(shape, mesh_shape, dp):
    """Shard dim 0 over as many DP axes as divide it (drop from the right)."""
    if dp is None:
        return P()
    axes = (dp,) if isinstance(dp, str) else tuple(dp)
    while axes:
        if shape[0] % mesh_shape_size(axes, mesh_shape) == 0 and \
                mesh_shape_size(axes, mesh_shape) > 1:
            return P(axes if len(axes) > 1 else axes[0])
        axes = axes[:-1]
    return P()


def batch_specs(cfg, batch_or_shapes, mesh_shape: dict) -> Any:
    """Batch dim over the layout's DP axes (greedily, divisibility-checked)."""
    dp = _dp_axes(mesh_shape, cfg.layout)

    def rule(keys, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return _batch_dim_spec(shape, mesh_shape, dp)

    return tree_map_with_keys(rule, batch_or_shapes)


def cache_specs(cfg, cache_or_shapes, mesh_shape: dict) -> Any:
    """Decode-cache sharding: batch over DP axes, kv-heads / ssm-heads over TP."""
    dp = _dp_axes(mesh_shape)

    def rule(keys, leaf):
        names = _path_names(keys)
        shape = _shape(leaf)
        name = names[-1]
        if name == "pos" or not shape:
            return P()
        if name == "slot_pos":       # (R, W)
            return P()
        if name in ("k", "v", "k_q", "v_q", "k_s", "v_s"):
            # (R, B, S, g, dh-or-1)
            return _mk(shape, mesh_shape, None, dp, None, "model", None)
        if name == "conv_x":         # (R, B, k-1, di)
            return _mk(shape, mesh_shape, None, dp, None, "model")
        if name == "conv_bc":        # (R, B, k-1, 2gn)
            return _mk(shape, mesh_shape, None, dp, None, None)
        if name == "ssm":            # (R, B, H, P, N)
            return _mk(shape, mesh_shape, None, dp, "model", None, None)
        return P()

    return tree_map_with_keys(rule, cache_or_shapes)


def zero1_specs(param_spec_tree, params_or_shapes, mesh_shape: dict, *,
                axes: tuple = ("data",)) -> Any:
    """ZeRO-1: insert DP axes on the first free divisible dim of every param
    spec.  ``axes=('data','model')`` for the pure-DP layout (params replicated
    -> moments sharded over the whole mesh)."""
    size = mesh_shape_size(axes, mesh_shape)

    def rule(leaf, spec):
        if size <= 1:
            return spec
        shape = _shape(leaf)
        names = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        used = set()
        for n in names:
            if n is not None:
                used.update((n,) if isinstance(n, str) else n)
        free = tuple(a for a in axes if a not in used)
        if not free:
            return spec
        ins = free if len(free) > 1 else free[0]
        fsize = mesh_shape_size(free, mesh_shape)
        out = list(names)
        for i, n in enumerate(out):
            if n is None and shape[i] % fsize == 0 and shape[i] >= fsize:
                out[i] = ins
                break
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    return tree_map(rule, params_or_shapes, param_spec_tree)


def validate_divisibility(spec_tree, shapes_tree, mesh_shape: dict) -> list:
    """Return a list of (path, shape, spec) that would not divide evenly, in
    the reference's leaf order."""
    bad = []

    def check(keys, leaf, spec):
        shape = _shape(leaf)
        for i, ax in enumerate(tuple(spec)):
            if ax is None:
                continue
            if shape[i] % mesh_shape_size(ax, mesh_shape) != 0:
                bad.append((keys, (_path_names(keys), shape, spec)))

    tree_map_with_keys(check, shapes_tree, spec_tree)
    return [entry for _, entry in sorted(bad, key=lambda b: b[0])]


# ------------------------------------------------------------ DTensors ----

def placements(spec, mesh) -> tuple:
    """One placement per dim of ``mesh``: ``Shard(i)`` on each mesh dim that
    ``spec`` names for tensor dim ``i``, ``Replicate()`` on the others.  A
    tensor dim split over several axes names them in the mesh's order (the
    first outermost, as DTensor splits it); another order, or an axis the
    mesh lacks, is refused."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(tuple(spec)):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec!r} names axes {missing} that mesh "
                             f"{names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec {spec!r} splits dim {dim} over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec!r} uses mesh axis {names[i]} "
                                 "twice")
            out[i] = Shard(dim)
    return tuple(out)


def _distribute(t, spec, mesh):
    """``t`` (the whole tensor, the same on every rank) as a DTensor laid
    out by ``spec``.  Where the local shard is the whole tensor (every
    tensor on a mesh of one device, or a replicated one) it is wrapped as it
    is, with no copy; otherwise each rank keeps its own slice (no
    collective)."""
    if not isinstance(t, torch.Tensor):
        return t                                   # the cache's int ``pos``
    pl = placements(spec, mesh)
    if all(p == Replicate() or mesh.size(i) == 1 for i, p in enumerate(pl)):
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return torch.distributed.tensor.distribute_tensor(t, mesh, pl,
                                                      src_data_rank=None)


def distribute_tree(tree, spec_tree, mesh):
    """A tree of whole tensors as DTensors on ``mesh``, each leaf laid out by
    its spec in ``spec_tree`` (a tree of the same structure)."""
    return tree_map(lambda t, spec: _distribute(t, spec, mesh), tree,
                    spec_tree)
