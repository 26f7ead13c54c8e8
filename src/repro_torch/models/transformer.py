"""Model assembly — decoder-only LM over heterogeneous layer patterns.

The port of ``src/repro/models/transformer.py``.  One super-block
(cfg.pattern) of layers is repeated cfg.n_repeats times: the parameter tree
is the reference's (``blocks`` a tuple over the pattern, every leaf with a
leading ``n_repeats`` dimension), and the reference's ``lax.scan`` over
repeats is a Python loop over that leading index.  Attention and Mamba-2
mixers with dense-MLP, MoE or no FFNs are ported.  An MoE layer runs
``apply_moe`` once over the whole (B·S, d) batch, as the reference does:
the capacity, and so which slots are dropped, depends on the number of
tokens dispatched together.  ``forward`` and ``loss_fn`` are differentiable
by autograd: a Mamba layer through the ``ssd_scan`` autograd Function
(its backward kernels on the card), attention through ``attn_impl_train``
"dense", "chunked" or "wedge" (the flash kernel has no backward and
refuses a call that needs one).

Every function also runs on DTensors: parameters laid out by
``parallel.param_specs`` and a batch by ``parallel.batch_specs``
(``parallel.distribute_tree``) on a ``DeviceMesh``.  The activations are
pinned to ``cfg.batch_axes`` as the reference pins them, what the model
makes from shapes (positions, the aux sum, the prefill's cache, laid out by
``parallel.cache_specs``) lies on the inputs' mesh, and the mixers and the
MoE run their per-head and per-group work on each rank's shards.  The
results are the plain path's, up to the order of float sums.

API (pure functions over parameter trees of tensors; caches are updated in
place):
    init_params(cfg, generator, dtype, device)   -> params
    forward(params, cfg, batch)                  -> (hidden (B, S, d), aux)
    loss_fn(params, cfg, batch)                  -> (loss, metrics)
    init_cache(cfg, batch, max_len, dtype, device, mesh) -> cache
    prefill(params, cfg, batch, max_len, dtype)  -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache)      -> (logits, cache)
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.common import (LeafShape, MetaGenerator, apply_mlp,
                                       apply_norm, chunked_cross_entropy,
                                       embed_tokens, init_embedding,
                                       init_mlp, init_norm, init_scale,
                                       normal)
from repro_torch.parallel.sharding import (P, _batch_dim_spec, cache_specs,
                                           mesh_shape_dict, mesh_shape_size,
                                           placements)
from repro_torch.parallel.shards import (batch_like, gather_fsdp,
                                         is_dtensor, local_shape, match,
                                         merge_rows, mergeable_rows, mesh_of,
                                         replicate_like, split_rows,
                                         tp_matmul)
from repro_torch.tree import tree_map, tree_map_with_keys

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step", "model_flops"]


def _dims(cfg: ArchConfig) -> attn.AttnDims:
    return attn.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                         tp=cfg.tp)


def _check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of the pattern is attention or Mamba-2 +
    dense/MoE/none."""
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "mamba"):
            raise ValueError(spec.mixer)
        if spec.ffn not in ("dense", "moe", "none"):
            raise ValueError(spec.ffn)


# ------------------------------------------------------------------- init ---

def _init_layer(cfg: ArchConfig, spec: LayerSpec, generator, dtype) -> dict:
    dev = generator.device
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev)}
    if spec.mixer == "attn":
        p["attn"] = attn.init_attention(generator, _dims(cfg), dtype,
                                        qkv_bias=cfg.qkv_bias)
    else:
        p["mamba"] = mamba2.init_mamba(generator, cfg.ssm, dtype)
    if spec.ffn == "dense":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                            dtype)
    elif spec.ffn == "moe":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
        p["moe"] = moe.init_moe(generator, cfg.d_model, cfg.moe, dtype)
    return p


def _stacked_layers(cfg: ArchConfig, spec: LayerSpec, generator, dtype):
    """``cfg.n_repeats`` layers of ``spec`` drawn one after another, as one
    tree whose leaves have a leading ``n_repeats`` dimension.  Each layer is
    copied into its slot as soon as it is drawn, so the weights are never
    held twice (a ``torch.stack`` of all layers would double the peak)."""
    def empty(t):
        if isinstance(t, dict):
            return {k: empty(v) for k, v in t.items()}
        return t.new_empty((cfg.n_repeats,) + tuple(t.shape))

    def put(out, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                put(out[k], v, i)
        else:
            out[i].copy_(t)

    layer = _init_layer(cfg, spec, generator, dtype)
    out = empty(layer)
    for rep in range(cfg.n_repeats):
        if rep:
            layer = _init_layer(cfg, spec, generator, dtype)
        put(out, layer, rep)
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                dtype=torch.float32, device="cuda") -> dict:
    """Random weights drawn from ``generator`` (a fresh one seeded 0 on
    ``device`` when None), laid out as the reference's tree; on
    ``device="meta"`` the tree's shapes and dtypes only."""
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = MetaGenerator()
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lies on {generator.device}, params on "
                         f"{dev}")
    _check_ported(cfg)
    params: dict = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dtype,
                                n_codebooks=cfg.n_codebooks),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, dev),
    }
    if cfg.n_codebooks:
        params["lm_head"] = normal(
            generator, (cfg.n_codebooks, cfg.d_model, cfg.vocab), dtype,
            init_scale("lm_head"))
    else:
        params["lm_head"] = normal(generator, (cfg.d_model, cfg.vocab), dtype,
                                   init_scale("lm_head"))
    if cfg.frontend == "patch":
        params["patch_proj"] = normal(
            generator, (cfg.patch_dim, cfg.d_model), dtype,
            init_scale("patch_proj", cfg.patch_dim))

    # stacked blocks: tuple over pattern positions, leading dim = n_repeats
    params["blocks"] = tuple(_stacked_layers(cfg, spec, generator, dtype)
                             for spec in cfg.pattern)
    return params


def _index(tree, i: int):
    """The ``i``-th slice of every leaf (a view)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------- forward ---

def _pin_batch(cfg: ArchConfig, x):
    """Pin the batch dim of an activation DTensor to ``cfg.batch_axes``, as
    the reference's ``_pin_batch`` does: dim 0 sharded over all of them
    (unless they hold a single rank between them), replicated over the
    other mesh dims.  Rows that the axes' ranks do not divide are split as
    ``torch.chunk`` splits them, where the reference pads them: rank 0
    holds ``ceil(rows / ranks)`` of them, the reference's padded share, and
    some ranks hold none.  A plain tensor lies on no mesh, so there it is
    the identity: the values are the same either way."""
    if not cfg.batch_axes or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    axes = tuple(cfg.batch_axes)
    spec = P(axes if len(axes) > 1 else axes[0]) \
        if _batch_ranks(cfg, x) > 1 else P()
    return x.redistribute(mesh, placements(spec, mesh))


def _batch_ranks(cfg: ArchConfig, x) -> int:
    """The ranks ``cfg.batch_axes`` hold between them on the mesh of the
    DTensor ``x`` (1 for a plain tensor)."""
    if not cfg.batch_axes or not is_dtensor(x):
        return 1
    return mesh_shape_size(tuple(cfg.batch_axes),
                           mesh_shape_dict(x.device_mesh))


def _pin_divisible(cfg: ArchConfig, x, rows: int | None = None):
    """``x`` (a DTensor) with its dim 0 sharded over as many of
    ``cfg.batch_axes`` as divide ``rows`` (dim 0's size by default):
    ``batch_specs``' rule, the layout in which DTensor may merge dim 0 with
    the next or split it, which it cannot do with an uneven split."""
    if not cfg.batch_axes or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    axes = tuple(cfg.batch_axes)
    spec = _batch_dim_spec((rows or x.shape[0],), mesh_shape_dict(mesh),
                           axes if len(axes) > 1 else axes[0])
    return x.redistribute(mesh, placements(spec, mesh))


def _gather_layer(p: dict, x) -> dict:
    """Layer ``p``'s FSDP weights gathered over 'data' once, at the layer's
    entry, for their products with the rows of ``x``
    (``shards.gather_fsdp``), so that the layer's own functions see whole
    matrices whatever the layout.  An MoE gathers its own weights: its
    experts meet the rows of their dispatch, not the layer's."""
    return {k: v if k == "moe" else gather_fsdp(v, x) for k, v in p.items()}


def _mix(cfg: ArchConfig, spec: LayerSpec, p: dict, x, positions):
    """norm1 -> the mixer over the full sequence; returns (out, k, v), with
    k and v None for a Mamba layer."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    if spec.mixer == "mamba":
        return mamba2.mamba_train(p["mamba"], h, cfg.ssm)[0], None, None
    return attn.attention_train(
        p["attn"], h, _dims(cfg), positions=positions,
        swa_window=cfg.swa_window, rope_theta=cfg.rope_theta,
        impl=cfg.attn_impl_train, chunk_q=cfg.attn_chunk_q,
        chunk_k=cfg.attn_chunk_k)


def _ffn(cfg: ArchConfig, spec: LayerSpec, p: dict, x):
    """norm2 -> the FFN, added to ``x``; returns (x, the MoE aux term, None
    for a dense or no FFN).  An MoE FFN dispatches all B·S tokens at once."""
    if spec.ffn == "none":
        return x, None
    h = apply_norm(cfg.norm, p["norm2"], x)
    if spec.ffn == "dense":
        return x + apply_mlp(p["mlp"], h, cfg.mlp_kind), None
    b, s, d = h.shape
    g = cfg.moe.dispatch_groups
    g = g if (b * s) % g == 0 else 1           # apply_moe's groups
    n = _batch_ranks(cfg, h)
    hp = _pin_batch(cfg, h) if b % n and g % n == 0 else None
    if hp is not None and mergeable_rows(hp):
        # fewer B rows than batch ranks (jamba's 16 over 32): whole groups
        # on every rank (32 groups of 2048 rows, one a rank, less than the
        # one row of 4096 a device of the reference's padded layout
        # holds), moved there from the pinned rows and back by one
        # all-to-all each way
        out, aux = moe.apply_moe(p["moe"], merge_rows(hp), cfg.moe)
        return x + split_rows(out, hp), aux
    # the B·S rows pinned on both sides of the MoE (left to DTensor, they
    # and their gradient may spread over all three mesh dims of a 512-rank
    # mesh), over the batch axes that divide its dispatch groups, merged
    # from and split back into B rows in batch_specs' layout of them
    rows = _pin_divisible(cfg, _pin_divisible(cfg, h).reshape(b * s, d), g)
    out, aux = moe.apply_moe(p["moe"], rows, cfg.moe)
    return x + _pin_batch(cfg, _pin_divisible(cfg, out, b).reshape(b, s, d)
                          ), aux


def _embed_inputs(params, cfg: ArchConfig, batch) -> tuple:
    """Returns (x (B,S,d), positions (B,S)) handling frontends."""
    x = embed_tokens(params["embed"], batch["tokens"])
    if cfg.frontend == "patch":
        # the product in the promoted type, as the reference's ``@``
        # promotes float32 patches against bfloat16 weights
        pe, w = batch["patch_embeds"], params["patch_proj"]
        t = torch.promote_types(pe.dtype, w.dtype)
        patches = tp_matmul(pe.to(t), w.to(t))
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    x = _pin_batch(cfg, x)
    b, s = x.shape[0], x.shape[1]
    positions = batch_like(torch.arange(s, device=x.device).expand(b, s), x)
    return x, positions


def _unstack(tree, n: int) -> list:
    """``n`` trees, the ``i``-th holding slice ``i`` of every leaf: one
    ``unbind`` a leaf, whose backward stacks the slices' gradients once
    (a slice taken per repeat would add a zero-filled full-size gradient per
    repeat)."""
    parts = tree_map(lambda t: t.unbind(0), tree)   # a tuple at each leaf
    return [tree_map(lambda _, p: p[i], tree, parts) for i in range(n)]


def forward(params, cfg: ArchConfig, batch):
    """Full-sequence forward -> (hidden (B,S,d) pre-final-norm, aux_loss).

    With ``cfg.remat`` each repeat of the pattern runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scan body): only its input is kept, and its activations are computed
    again in the backward pass."""
    _check_ported(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    blocks = [_unstack(b, cfg.n_repeats) for b in params["blocks"]]

    def body(h, *layer_params):
        h = _pin_batch(cfg, h)
        aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                         device=h.device), h)
        for spec, p in zip(cfg.pattern, layer_params):
            p = _gather_layer(p, h)
            out, _, _ = _mix(cfg, spec, p, h, positions)
            h, a = _ffn(cfg, spec, p, h + out)
            if a is not None:
                aux = aux + a
        return h, aux

    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    for rep in range(cfg.n_repeats):
        layer_params = [b[rep] for b in blocks]
        if cfg.remat:
            x, a = checkpoint(body, x, *layer_params, use_reentrant=False)
        else:
            x, a = body(x, *layer_params)
        aux = aux + a
    return x, aux


def loss_fn(params, cfg: ArchConfig, batch):
    """Mean next-token NLL (+ MoE aux) -> (loss, {"nll", "aux"}).

    batch: tokens, labels (+ frontend extras).  Patches carry no labels;
    codebook archs average the NLL over the codebooks."""
    hidden, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.frontend == "patch":  # patches carry no labels
        pad = batch_like(torch.full((labels.shape[0], cfg.n_patches), -1,
                                    dtype=labels.dtype, device=labels.device),
                         labels)
        labels = torch.cat([pad, labels], dim=1)
    ce = dict(chunk=cfg.loss_chunk, norm_kind=cfg.norm,
              norm_params=params["final_norm"])
    if cfg.n_codebooks:
        loss = sum(chunked_cross_entropy(hidden, labels[..., k],
                                         params["lm_head"][k], **ce)
                   for k in range(cfg.n_codebooks)) / cfg.n_codebooks
    else:
        loss = chunked_cross_entropy(hidden, labels, params["lm_head"], **ce)
    return loss + aux, {"nll": loss, "aux": aux}


def _logits(params, cfg: ArchConfig, h):
    if cfg.n_codebooks:
        # the reference's einsum "bd,kdv->bkv", one codebook's product at a
        # time: einsum folds (k, v) into one dim, which DTensor (torch 2.11)
        # refuses where the vocab is sharded
        return torch.stack([tp_matmul(h, w)
                            for w in params["lm_head"].unbind(0)], dim=1)
    return tp_matmul(h, params["lm_head"])


# ----------------------------------------------------------------- decode ---

def cache_leaf_shapes(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.float32) -> dict:
    """``init_cache``'s tree with ``LeafShape`` leaves: the shapes and
    dtypes alone, allocating nothing."""
    blocks = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            one = attn.attention_cache_shapes(
                batch, max_len, _dims(cfg), dtype, kv_quant=cfg.kv_quant,
                swa_window=cfg.swa_window)
        else:
            one = mamba2.mamba_cache_shapes(batch, cfg.ssm, dtype)
        blocks.append({k: LeafShape((cfg.n_repeats,) + v.shape, v.dtype)
                       for k, v in one.items()})
    return {"blocks": tuple(blocks), "pos": 0}


def _cache_fill(keys) -> int:
    """A cache leaf's first value: zero, but a ring buffer's slot
    positions, -1 (as ``attention.init_attention_cache`` fills them)."""
    return -1 if keys[-1] == "slot_pos" else 0


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda", mesh=None):
    """Cache: tuple over pattern positions, leading dim = n_repeats; ``pos``
    is the next position, a Python int.

    With ``mesh`` (a ``DeviceMesh`` of ``device``'s type, or any mesh for
    ``device="meta"``) each leaf is a DTensor laid out by
    ``parallel.cache_specs`` and allocated at its shard's shape: no rank
    ever holds the whole cache."""
    dev = resolve_device(device)
    _check_ported(cfg)
    shapes = cache_leaf_shapes(cfg, batch, max_len, dtype)
    if mesh is not None:
        if dev.type not in ("meta", mesh.device_type):
            raise ValueError(f"a {dev.type} cache on a {mesh.device_type} "
                             "mesh")
        return _cache_shards(shapes, cfg, mesh, dev)
    return tree_map_with_keys(
        lambda keys, s: torch.full(s.shape, _cache_fill(keys), dtype=s.dtype,
                                   device=dev)
        if isinstance(s, LeafShape) else s, shapes)


def _cache_shards(shapes, cfg: ArchConfig, mesh, dev: torch.device):
    """The cache of ``shapes`` (``cache_leaf_shapes``) as DTensors on
    ``mesh``, each rank allocating its own shard on ``dev`` (the mesh's
    device, or meta), filled as ``_cache_fill`` says; a meta shard holds no
    values."""
    specs = cache_specs(cfg, shapes, mesh_shape_dict(mesh))

    def alloc(keys, t, spec):
        if not isinstance(t, LeafShape):
            return t                                   # ``pos``
        pl = placements(spec, mesh)
        if dev.type == "meta":
            # the shard's shape from the global one: no tensor is made but
            # the shard itself
            stride = tuple(int(np.prod(t.shape[i + 1:]))
                           for i in range(len(t.shape)))
            return DTensor.from_local(
                torch.empty(local_shape(t.shape, mesh, pl), dtype=t.dtype,
                            device="meta"),
                mesh, pl, run_check=False, shape=t.shape, stride=stride)
        return torch.distributed.tensor.full(
            t.shape, _cache_fill(keys), dtype=t.dtype, device_mesh=mesh,
            placements=pl)

    return tree_map_with_keys(alloc, shapes, specs)


def decode_step(params, cfg: ArchConfig, tokens, cache):
    """One token for every sequence in the batch.

    tokens: (B, 1) int — or (B, 1, K) for codebook archs.  Writes the new
    keys and values into ``cache`` in place and advances ``cache["pos"]``.
    Returns (logits (B, V) or (B, K, V), cache).
    """
    _check_ported(cfg)
    pos = int(cache["pos"])
    x = embed_tokens(params["embed"], tokens)
    for rep in range(cfg.n_repeats):
        x = _pin_batch(cfg, x)
        for j, spec in enumerate(cfg.pattern):
            p = _gather_layer(_index(params["blocks"][j], rep), x)
            c = _index(cache["blocks"][j], rep)
            h = apply_norm(cfg.norm, p["norm1"], x)
            if spec.mixer == "attn":
                out, _ = attn.attention_decode(
                    p["attn"], h, c, pos, _dims(cfg),
                    swa_window=cfg.swa_window, rope_theta=cfg.rope_theta)
            else:
                out, _ = mamba2.mamba_decode(p["mamba"], h, c, cfg.ssm)
            x, _ = _ffn(cfg, spec, p, x + out)
    h = apply_norm(cfg.norm, params["final_norm"], x[:, 0])
    cache["pos"] = pos + 1
    return _logits(params, cfg, h), cache


def prefill(params, cfg: ArchConfig, batch, max_len: int,
            dtype=torch.float32):
    """Process a full prompt, build the cache, return last-position logits.

    Runs the train forward (``cfg.attn_impl_train``; Mamba layers through
    the ``ssd_scan`` kernel) and bulk-fills a fresh cache on the device of
    the weights.
    """
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len, dtype, device=x.device,
                       mesh=mesh_of(x))
    for rep in range(cfg.n_repeats):
        x = _pin_batch(cfg, x)
        for j, spec in enumerate(cfg.pattern):
            p = _gather_layer(_index(params["blocks"][j], rep), x)
            c = _index(cache["blocks"][j], rep)
            if spec.mixer == "attn":
                out, k, v = _mix(cfg, spec, p, x, positions)
                attn.fill_attention_cache(c, k, v, swa_window=cfg.swa_window)
            else:
                out, filled = mamba2.mamba_prefill(
                    p["mamba"], apply_norm(cfg.norm, p["norm1"], x), cfg.ssm)
                for key, t in filled.items():   # conv caches take c's dtype
                    c[key].copy_(match(t, c[key]))
            x, _ = _ffn(cfg, spec, p, x + out)
    h = apply_norm(cfg.norm, params["final_norm"], x[:, -1])
    cache["pos"] = s
    return _logits(params, cfg, h), cache


# ------------------------------------------------------------------ flops ---

def model_flops(cfg: ArchConfig, tokens: int, kv_len: int | None = None,
                *, mode: str = "train") -> float:
    """MODEL_FLOPS: 6·N·D for train (fwd+bwd), 2·N_active·D for inference
    fwd, plus attention score/PV terms."""
    d = cfg.d_model
    kv = kv_len if kv_len is not None else tokens
    _check_ported(cfg)
    dims = _dims(cfg)
    per_block = 0.0
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            per_block += attn.attn_flops(dims, tokens, kv,
                                         causal=(mode != "decode"))
        else:
            per_block += mamba2.mamba_flops(cfg.ssm, tokens)
        if spec.ffn == "dense":
            n_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            per_block += 2.0 * n_mats * d * cfg.d_ff * tokens
        elif spec.ffn == "moe":
            per_block += moe.moe_flops(d, cfg.moe, tokens)
    total = per_block * cfg.n_repeats
    heads = max(cfg.n_codebooks, 1)
    total += 2.0 * tokens * d * cfg.vocab * heads   # lm head
    total += 2.0 * tokens * d                        # embed lookup ~free
    if mode == "train":
        total *= 3.0  # fwd + bwd(2x)
    return total
