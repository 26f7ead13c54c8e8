"""Reduced same-family configs for CPU smoke tests (full configs are exercised
only via the ShapeDtypeStruct dry-run).

Copied from ``src/repro/configs/smoke.py``, imports pointed at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.moe import MoEConfig

__all__ = ["smoke_config"]


def smoke_config(name: str, **overrides) -> ArchConfig:
    cfg = get_arch(name)
    d = 64
    kw: dict = dict(
        n_layers=len(cfg.pattern),      # one super-block
        d_model=d,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        d_head=16,
        loss_chunk=32,
        attn_chunk_q=32, attn_chunk_k=32,
        remat=False,
        kv_quant=cfg.kv_quant,
    )
    if cfg.n_heads > 1:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 4 if cfg.n_kv_heads == cfg.n_heads else 2
    if cfg.moe is not None:
        # capacity_factor 8: effectively dropless at smoke scale, so
        # decode-vs-prefill consistency checks are exact
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_shared=32 if cfg.moe.n_shared else 0, capacity_factor=8.0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_model=d, d_state=16, d_conv=4, expand=2,
                              head_dim=16, n_groups=1, chunk=16)
    if cfg.frontend == "patch":
        kw["patch_dim"] = 32
        kw["n_patches"] = 8
    kw.update(overrides)
    return cfg.replace(**kw)
