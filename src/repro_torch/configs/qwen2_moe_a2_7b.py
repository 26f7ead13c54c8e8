"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4, expert d_ff 1408
[hf:Qwen/Qwen1.5-MoE-A2.7B].

Copied from ``src/repro/configs/qwen2_moe_a2_7b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    norm="rms", mlp_kind="swiglu",
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared=4, d_ff_shared=5632, capacity_factor=1.25),
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    loss_chunk=1024,
)
