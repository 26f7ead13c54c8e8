"""Architecture config schema + registry for the 10 assigned architectures.

Copied from ``src/repro/configs/base.py``, imports pointed at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.moe import MoEConfig

__all__ = ["LayerSpec", "ArchConfig", "get_arch", "ARCH_IDS"]

ARCH_IDS = (
    "olmo-1b", "minitron-8b", "qwen1.5-32b", "yi-6b", "pixtral-12b",
    "mamba2-1.3b", "jamba-1.5-large-398b", "qwen2-moe-a2.7b", "mixtral-8x7b",
    "musicgen-large",
)

_MODULES = {
    "olmo-1b": "olmo_1b",
    "minitron-8b": "minitron_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "yi-6b": "yi_6b",
    "pixtral-12b": "pixtral_12b",
    "mamba2-1.3b": "mamba2_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "musicgen-large": "musicgen_large",
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"      # 'attn' | 'mamba'
    ffn: str = "dense"       # 'dense' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    norm: str = "rms"                    # 'rms' | 'ln_nonparam'
    mlp_kind: str = "swiglu"             # 'swiglu' | 'geglu' | 'relu2' | 'gelu'
    qkv_bias: bool = False
    swa_window: Optional[int] = None
    rope_theta: float = 10000.0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    pattern: tuple = (LayerSpec(),)      # super-block, repeated

    frontend: str = "none"               # 'none' | 'patch' | 'codebook'
    n_codebooks: int = 0
    patch_dim: int = 1024
    n_patches: int = 1024                # patches prepended to the text sequence

    # distribution / numerics knobs (overridable per run)
    tp: int = 1                          # model-axis size the params are laid out for
    kv_quant: bool = False               # int8 KV cache for decode
    fsdp: bool = False                   # shard params over the data axis too
    # layout: 'tp'     — Megatron TP over 'model', batch over DP axes (baseline)
    #         'dp'     — params replicated, batch over ALL axes (small archs)
    #         'fsdp2d' — params sharded over both axes (per-layer all-gather),
    #                    batch over all axes, microbatches -> 1
    layout: str = "tp"
    # mesh axes the batch dim is pinned to inside the model (explicit
    # with_sharding_constraint on the hidden stream — GSPMD otherwise loses
    # the batch sharding through the embedding gather; see results/perf_log.md
    # iteration 4).  Empty = no constraints (single-device runs).
    batch_axes: tuple = ()
    # (axis_name, axis_size) used to shard the gradient-accumulator carry in
    # the microbatch scan: turns per-microbatch gradient all-reduces into
    # reduce-scatters (perf_log.md iteration 5).  None = no constraint.
    grad_shard: tuple = ()
    opt_dtype: str = "float32"           # adam moment dtype
    attn_impl_train: str = "chunked"     # 'dense' | 'chunked'
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    loss_chunk: int = 2048
    remat: bool = True
    sub_quadratic: bool = False          # eligible for long_500k

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError("n_layers must divide into the pattern")

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks), logical heads."""
        d, dh = self.d_model, self.d_head
        # embedding table(s) + untied lm head(s)
        emb = self.vocab * d * 2 * max(self.n_codebooks, 1)
        total = float(emb)
        if self.frontend == "patch":
            total += self.patch_dim * d
        per_pattern = {"attn": d * dh * (self.n_heads + 2 * self.n_kv_heads)
                       + self.n_heads * dh * d}
        n_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        for spec in self.pattern:
            cnt = 0.0
            if spec.mixer == "attn":
                cnt += per_pattern["attn"]
            elif spec.mixer == "mamba":
                s = self.ssm
                cnt += d * (2 * s.d_inner + 2 * s.n_groups * s.d_state
                            + s.n_heads) + s.d_inner * d
            if spec.ffn == "dense":
                cnt += n_mats * d * self.d_ff
            elif spec.ffn == "moe":
                m = self.moe
                cnt += m.n_experts * n_mats * d * m.d_ff_expert + d * m.n_experts
                if m.n_shared:
                    cnt += n_mats * d * (m.d_ff_shared or m.n_shared * m.d_ff_expert)
            total += cnt * self.n_repeats
        return total

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def get_arch(name: str, **overrides) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
