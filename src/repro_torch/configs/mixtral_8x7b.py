"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention (4096)
[arXiv:2401.04088].  SWA bounds the decode KV cache -> long_500k runs with a
rolling window cache.

Copied from ``src/repro/configs/mixtral_8x7b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000,
    norm="rms", mlp_kind="swiglu", swa_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336,
                  capacity_factor=1.25),
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    sub_quadratic=True,   # SWA: bounded KV, linear prefill in S
)
