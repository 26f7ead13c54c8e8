"""yi-6b [dense] — llama-arch GQA kv=4 [arXiv:2403.04652].

kv=4 < tp=16: kv heads are duplicated 4x across the model axis (exact — standard
GQA tensor-parallel practice).

Copied from ``src/repro/configs/yi_6b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, vocab=64000,
    norm="rms", mlp_kind="swiglu",
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
)
