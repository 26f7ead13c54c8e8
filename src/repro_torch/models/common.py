"""Shared layers: norms, RoPE, MLPs, embeddings.

The port of ``src/repro/models/common.py``: pure functions over explicit
parameter dicts of tensors, computing on the device their inputs lie on.
Initialisers draw from a ``torch.Generator`` on that device; the JAX package's
``jax.random`` keys give other numbers, so tests carry weights across with
``repro_torch.models.convert.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.shards import gather_fsdp, nll_sum, \
    replicate_like, tp_matmul

__all__ = ["rms_norm", "layer_norm_nonparam", "make_norm", "init_norm",
           "apply_norm", "rope_frequencies", "apply_rope", "init_mlp",
           "apply_mlp", "mlp_flops", "chunked_cross_entropy",
           "init_embedding", "embed_tokens", "normal", "init_scale",
           "MetaGenerator", "LeafShape"]


@dataclasses.dataclass(frozen=True)
class LeafShape:
    """A tensor's shape and dtype, allocating nothing: a leaf of a shape
    tree (a tuple would be taken for a node of the tree)."""

    shape: tuple
    dtype: torch.dtype


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which torch
    has none of: initialisers build shapes there and draw no numbers."""

    device = torch.device("meta")


def normal(generator: torch.Generator, shape, dtype, scale: float
           ) -> torch.Tensor:
    """``N(0, 1) * scale`` of ``shape`` on the generator's device."""
    x = torch.randn(shape, dtype=torch.float32, device=generator.device,
                    generator=None if isinstance(generator, MetaGenerator)
                    else generator)
    return (x * scale).to(dtype)


# The scale of every weight drawn as ``normal``, by the leaf's name: a fixed
# one, or 1 / sqrt(fan-in), the length of the sums its product takes (dim -2
# of an unpadded leaf).  Every initialiser of the port and
# ``models/shard_init.py`` take their scales from here.
INIT_FIXED = {"table": 0.02, "lm_head": 0.02, "bq": 0.01, "bk": 0.01,
              "bv": 0.01, "conv_wx": 0.2, "conv_wbc": 0.2}
INIT_FAN_IN = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "router",
                         "patch_proj", "wz", "wx", "wb", "wc", "wdt",
                         "out_proj"})


def init_scale(name: str, fan_in: int | None = None) -> float:
    """The scale of the leaf ``name`` (``INIT_FIXED``, else 1 / sqrt(
    ``fan_in``)); a leaf drawn otherwise raises ``ValueError``."""
    if name in INIT_FIXED:
        return INIT_FIXED[name]
    if name in INIT_FAN_IN and fan_in:
        return float(1.0 / math.sqrt(fan_in))
    raise ValueError(f"the leaf {name!r} is not drawn as N(0, 1) times a "
                     "scale")


# ----------------------------------------------------------------- norms ----

def rms_norm(x, scale, *, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    return out.to(x.dtype)


def layer_norm_nonparam(x, _unused=None, *, eps=1e-5):
    """OLMo's non-parametric LayerNorm: no scale, no bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(kind: str):
    if kind == "rms":
        return rms_norm
    if kind == "ln_nonparam":
        return layer_norm_nonparam
    raise ValueError(kind)


def init_norm(kind: str, d: int, dtype, device) -> dict:
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {}  # non-parametric


def apply_norm(kind: str, params: dict, x):
    return make_norm(kind)(x, params.get("scale"))


# ------------------------------------------------------------------ RoPE ----

def rope_frequencies(d_head: int, theta: float = 10000.0, device=None
                     ) -> torch.Tensor:
    """float64 frequencies on ``device``, computed there: a host array would
    cost a synchronising host-to-device copy on every call."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float64, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device).float()
    angles = positions[..., :, None].float() * freqs   # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]              # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLPs ----

def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(kind: str):
    return {"silu": F.silu, "gelu": _gelu,
            "relu2": lambda x: torch.square(F.relu(x))}[kind]


def init_mlp(generator: torch.Generator, d: int, ff: int, kind: str,
             dtype) -> dict:
    """kind: 'swiglu' | 'geglu' | 'relu2' | 'gelu'."""
    p = {"wi": normal(generator, (d, ff), dtype, init_scale("wi", d)),
         "wo": normal(generator, (ff, d), dtype, init_scale("wo", ff))}
    if kind in ("swiglu", "geglu"):
        p["wg"] = normal(generator, (d, ff), dtype, init_scale("wg", d))
    return p


def apply_mlp(params: dict, x, kind: str):
    """The MLP of ``x``; on DTensors its hidden dim split over 'model' (the
    reference's layout), ``wo``'s partial sums reduced at its output."""
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(tp_matmul(x, params["wg"])) * tp_matmul(x, params["wi"])
    else:
        h = _act(kind)(tp_matmul(x, params["wi"]))
    return tp_matmul(h, params["wo"])


def mlp_flops(d: int, ff: int, kind: str, tokens: int) -> float:
    n_mats = 3 if kind in ("swiglu", "geglu") else 2
    return 2.0 * n_mats * d * ff * tokens


# ------------------------------------------------- chunked cross-entropy ----

def chunked_cross_entropy(hidden, labels, lm_head, *, chunk: int = 2048,
                          norm_kind: str = "rms",
                          norm_params: dict | None = None):
    """Mean NLL over labels >= 0; logits never materialized beyond one chunk.

    hidden: (B, S, d) pre-final-norm activations; lm_head: (d, V).  Each
    chunk's norm, logits, logsumexp and target are computed again in the
    backward pass (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so only one chunk's logits are ever alive.  On
    DTensors each rank holds only its rows of a chunk's logits, and only
    its columns where the head splits the vocab (``shards.nll_sum``); a
    head split on d gives logits whole over the vocab, and a replicated
    head too.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1  # largest divisor <= requested
    # an FSDP head gathered once for every chunk (its gradient
    # reduce-scattered once)
    lm_head = gather_fsdp(lm_head, hidden)

    def chunk_loss(h_c, l_c):
        if norm_params is not None:
            h_c = apply_norm(norm_kind, norm_params, h_c)
        return nll_sum(tp_matmul(h_c, lm_head).float(), l_c)  # (B, c, V)

    tot = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=hidden.device), hidden)
    for i in range(0, s, chunk):
        tot = tot + checkpoint(chunk_loss, hidden[:, i:i + chunk],
                               labels[:, i:i + chunk], use_reentrant=False)
    cnt = (labels >= 0).sum()
    return tot / torch.clamp(cnt, min=1)


# ------------------------------------------------------------- embedding ----

def init_embedding(generator: torch.Generator, vocab: int, d: int, dtype,
                   n_codebooks: int = 0) -> dict:
    shape = (n_codebooks, vocab, d) if n_codebooks else (vocab, d)
    return {"table": normal(generator, shape, dtype, init_scale("table"))}


def embed_tokens(params: dict, tokens):
    table = params["table"]
    tokens = tokens.long()
    if table.ndim == 3:  # codebooks: tokens (..., K)
        return sum(F.embedding(tokens[..., i], table[i])
                   for i in range(table.shape[0]))
    return F.embedding(tokens, table)
