"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887].

72 layers = 9 super-blocks of 8 (attention at in-block index 4, the rest Mamba;
MoE at odd in-block indices).  Deviation noted in DESIGN.md: the paper's Mamba-1
blocks are implemented with our Mamba-2/SSD block (same state-space role).
398B params on a 256-chip v5e pod is storage-critical: params are FSDP-sharded over
the data axis in addition to TP, adam moments are bf16, and training uses
gradient-accumulation microbatches.

Copied from ``src/repro/configs/jamba_1_5_large_398b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.moe import MoEConfig

_P = []
for j in range(8):
    mixer = "attn" if j == 4 else "mamba"
    ffn = "moe" if j % 2 == 1 else "dense"
    _P.append(LayerSpec(mixer=mixer, ffn=ffn))

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    norm="rms", mlp_kind="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  capacity_factor=1.25),
    ssm=SSMConfig(d_model=8192, d_state=128, d_conv=4, expand=2, head_dim=128,
                  n_groups=1, chunk=256),
    pattern=tuple(_P),
    sub_quadratic=True,
    fsdp=True, opt_dtype="bfloat16",
    loss_chunk=1024,
)
