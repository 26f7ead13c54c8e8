"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838].

Copied from ``src/repro/configs/olmo_1b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=8192, vocab=50304,
    norm="ln_nonparam", mlp_kind="swiglu",
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
)
