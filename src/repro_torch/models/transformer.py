"""Model assembly — decoder-only LM over heterogeneous layer patterns.

The port of ``src/repro/models/transformer.py``.  One super-block
(cfg.pattern) of layers is repeated cfg.n_repeats times: the parameter tree
is the reference's (``blocks`` a tuple over the pattern, every leaf with a
leading ``n_repeats`` dimension), and the reference's ``lax.scan`` over
repeats is a Python loop over that leading index.  Attention and Mamba-2
mixers with dense-MLP, MoE or no FFNs are ported; ``loss_fn`` comes with
training.  An MoE layer runs ``apply_moe`` once over the whole (B·S, d)
batch, as the reference does: the capacity, and so which slots are dropped,
depends on the number of tokens dispatched together.

API (pure functions over parameter trees of tensors; caches are updated in
place):
    init_params(cfg, generator, dtype, device)   -> params
    forward(params, cfg, batch)                  -> (hidden (B, S, d), aux)
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    prefill(params, cfg, batch, max_len, dtype)  -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache)      -> (logits, cache)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.common import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       normal)

__all__ = ["init_params", "forward", "init_cache", "prefill", "decode_step",
           "model_flops"]


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
    ``device`` when None), laid out as the reference's tree."""
    dev = resolve_device(device)
    if generator is None:
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
            generator, (cfg.n_codebooks, cfg.d_model, cfg.vocab), dtype, 0.02)
    else:
        params["lm_head"] = normal(generator, (cfg.d_model, cfg.vocab), dtype,
                                   0.02)
    if cfg.frontend == "patch":
        params["patch_proj"] = normal(
            generator, (cfg.patch_dim, cfg.d_model), dtype,
            float(1.0 / np.sqrt(cfg.patch_dim)))

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
    """The identity on one device.  The reference pins the batch dim to
    mesh axes for GSPMD; the port has no mesh yet (ROADMAP Queue 1 item 13),
    so a config that names batch axes is refused."""
    if cfg.batch_axes:
        raise NotImplementedError(
            "cfg.batch_axes needs the sharded port (ROADMAP Queue 1 item 13)")
    return x


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
    out, aux = moe.apply_moe(p["moe"], h.reshape(b * s, d), cfg.moe)
    return x + out.reshape(b, s, d), aux


def _embed_inputs(params, cfg: ArchConfig, batch) -> tuple:
    """Returns (x (B,S,d), positions (B,S)) handling frontends."""
    x = embed_tokens(params["embed"], batch["tokens"])
    if cfg.frontend == "patch":
        patches = batch["patch_embeds"] @ params["patch_proj"]
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    x = _pin_batch(cfg, x)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def forward(params, cfg: ArchConfig, batch):
    """Full-sequence forward -> (hidden (B,S,d) pre-final-norm, aux_loss)."""
    _check_ported(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for rep in range(cfg.n_repeats):
        x = _pin_batch(cfg, x)
        for j, spec in enumerate(cfg.pattern):
            p = _index(params["blocks"][j], rep)
            out, _, _ = _mix(cfg, spec, p, x, positions)
            x, a = _ffn(cfg, spec, p, x + out)
            if a is not None:
                aux = aux + a
    return x, aux


def _logits(params, cfg: ArchConfig, h):
    if cfg.n_codebooks:
        return torch.einsum("bd,kdv->bkv", h, params["lm_head"])
    return h @ params["lm_head"]


# ----------------------------------------------------------------- decode ---

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda"):
    """Cache: tuple over pattern positions, leading dim = n_repeats; ``pos``
    is the next position, a Python int."""
    dev = resolve_device(device)
    _check_ported(cfg)
    blocks = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            one = attn.init_attention_cache(
                batch, max_len, _dims(cfg), dtype, kv_quant=cfg.kv_quant,
                swa_window=cfg.swa_window, device=dev)
        else:
            one = mamba2.init_mamba_cache(batch, cfg.ssm, dtype, device=dev)
        blocks.append({k: v.expand((cfg.n_repeats,) + v.shape).clone()
                       for k, v in one.items()})
    return {"blocks": tuple(blocks), "pos": 0}


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
            p = _index(params["blocks"][j], rep)
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
    cache = init_cache(cfg, b, max_len, dtype, device=x.device)
    for rep in range(cfg.n_repeats):
        x = _pin_batch(cfg, x)
        for j, spec in enumerate(cfg.pattern):
            p = _index(params["blocks"][j], rep)
            c = _index(cache["blocks"][j], rep)
            if spec.mixer == "attn":
                out, k, v = _mix(cfg, spec, p, x, positions)
                attn.fill_attention_cache(c, k, v, swa_window=cfg.swa_window)
            else:
                out, filled = mamba2.mamba_prefill(
                    p["mamba"], apply_norm(cfg.norm, p["norm1"], x), cfg.ssm)
                for key, t in filled.items():   # conv caches take c's dtype
                    c[key].copy_(t)
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
