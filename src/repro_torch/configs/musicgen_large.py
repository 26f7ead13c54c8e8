"""musicgen-large [audio] — decoder-only over EnCodec tokens, 4 codebooks,
vocab 2048 [arXiv:2306.05284].

Frontend STUB: tokens arrive as (B, S, 4) codebook ids (the EnCodec encoder is
outside the backbone scope); embeddings are summed across codebooks and the head
emits 4 × 2048 logits.  The delay-pattern bookkeeping lives in the tokenizer, not
the backbone.  Deviation: RMSNorm + RoPE in place of MusicGen's LN + sinusoidal
(positional scheme does not change the systems shape; noted in DESIGN.md).

Copied from ``src/repro/configs/musicgen_large.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    norm="rms", mlp_kind="gelu",
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="codebook", n_codebooks=4,
)
