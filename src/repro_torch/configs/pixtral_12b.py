"""pixtral-12b [vlm] — mistral-nemo backbone (head_dim 128 ≠ d_model/n_heads);
vision frontend is a STUB: input_specs() supplies precomputed patch embeddings
(B, n_patches, 1024) which a linear projector maps into the sequence
[hf:mistralai/Pixtral-12B-2409].

Copied from ``src/repro/configs/pixtral_12b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072,
    norm="rms", mlp_kind="swiglu",
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="patch", patch_dim=1024, n_patches=1024,
    rope_theta=1_000_000.0,
    loss_chunk=1024,
)
