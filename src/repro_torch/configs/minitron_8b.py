"""minitron-8b [dense] — pruned Nemotron, squared-ReLU FFN, 256k vocab
[arXiv:2407.14679].

Copied from ``src/repro/configs/minitron_8b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=256000,
    norm="rms", mlp_kind="relu2",
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    loss_chunk=1024,  # 256k vocab: keep per-chunk logits small
)
