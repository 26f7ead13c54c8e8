"""qwen1.5-32b [dense] — MHA with QKV bias [hf:Qwen/Qwen1.5 family].

40 heads don't divide a 16-way model axis: heads are Megatron-style padded 40->48
at init for tp=16 (exact math — see models/attention.py).  Decode at 32k×128 uses an
int8 KV cache (bf16 KV would need 21 GB/chip on a single pod).

Copied from ``src/repro/configs/qwen1_5_32b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
    d_ff=27392, vocab=152064,
    norm="rms", mlp_kind="swiglu", qkv_bias=True,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    kv_quant=True,
    loss_chunk=1024,
)
