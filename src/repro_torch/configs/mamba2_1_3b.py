"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality)
[arXiv:2405.21060].  d_inner=4096, 64 heads × head_dim 64, d_state 128.

Copied from ``src/repro/configs/mamba2_1_3b.py``, imports pointed at ``repro_torch``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.mamba2 import SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_head=64,
    d_ff=0, vocab=50280,
    norm="rms",
    ssm=SSMConfig(d_model=2048, d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    sub_quadratic=True,
)
