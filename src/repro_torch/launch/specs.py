"""Meta-device stand-ins for every model input (no device allocation).

The port of ``src/repro/launch/specs.py``: meta tensors take the place of
``jax.ShapeDtypeStruct`` and ``jax.eval_shape``.  For VLM cells the text
length is (seq_len - n_patches) and the patch embeddings arrive precomputed
(the modality frontend is a stub).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeCell
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

__all__ = ["train_input_specs", "prefill_input_specs", "decode_input_specs",
           "params_shapes", "opt_shapes", "cache_shapes"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_shape(cfg: ArchConfig, batch: int, seq: int) -> tuple:
    if cfg.n_codebooks:
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def train_input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    s_text = s - cfg.n_patches if cfg.frontend == "patch" else s
    out = {
        "tokens": _sds(_token_shape(cfg, b, s_text), torch.int32),
        "labels": _sds(_token_shape(cfg, b, s_text), torch.int32),
    }
    if cfg.frontend == "patch":
        out["patch_embeds"] = _sds((b, cfg.n_patches, cfg.patch_dim),
                                   torch.bfloat16)
    return out


def prefill_input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    s_text = s - cfg.n_patches if cfg.frontend == "patch" else s
    out = {"tokens": _sds(_token_shape(cfg, b, s_text), torch.int32)}
    if cfg.frontend == "patch":
        out["patch_embeds"] = _sds((b, cfg.n_patches, cfg.patch_dim),
                                   torch.bfloat16)
    return out


def decode_input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    return {"tokens": _sds(_token_shape(cfg, cell.global_batch, 1),
                           torch.int32)}


def params_shapes(cfg: ArchConfig, dtype=torch.bfloat16):
    return T.init_params(cfg, dtype=dtype, device="meta")


def opt_shapes(cfg: ArchConfig, opt_cfg, params_sds):
    return adamw_init(params_sds, opt_cfg)


def cache_shapes(cfg: ArchConfig, cell: ShapeCell, dtype=torch.bfloat16):
    return T.init_cache(cfg, cell.global_batch, cell.seq_len, dtype,
                        device="meta")
