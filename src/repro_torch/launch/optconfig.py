"""Per-arch distribution configs for the production meshes — baseline and the
hillclimbed (--opt) variants.  NO jax/device side effects: importable from
benchmarks and the dry-run alike (the XLA_FLAGS override lives ONLY in
launch/dryrun.py).

Hillclimb provenance: results/perf_log.md.

Copied from ``src/repro/launch/optconfig.py`` with its imports pointed at
``repro_torch``. It is plain Python, as the original is, so each config it
builds equals the reference's field by field.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_arch

__all__ = ["TRAIN_MICROBATCHES", "OPT_OVERRIDES", "OPT_MICROBATCHES",
           "build_cfg"]

# gradient-accumulation microbatches per arch for train_4k (sized so the
# per-layer remat carries fit HBM; DESIGN.md §5)
TRAIN_MICROBATCHES = {
    "olmo-1b": 2, "minitron-8b": 8, "qwen1.5-32b": 16, "yi-6b": 8,
    "pixtral-12b": 8, "mamba2-1.3b": 8, "jamba-1.5-large-398b": 16,
    "qwen2-moe-a2.7b": 4, "mixtral-8x7b": 8, "musicgen-large": 8,
}

# 'layout'/'fsdp'/microbatch overrides apply to TRAIN cells only (weights must
# be stationary at decode — perf_log iteration-2 lesson); kv_quant (int8 KV
# cache) applies wherever a cache exists.
OPT_OVERRIDES = {
    "olmo-1b": dict(layout="dp", kv_quant=True),
    "mamba2-1.3b": dict(layout="dp"),
    "musicgen-large": dict(layout="dp", kv_quant=True),
    "minitron-8b": dict(fsdp=True, kv_quant=True),
    # wedge attention: causal-optimal chunk schedule (halves executed score
    # FLOPs vs the all-pairs baseline; exactness tested in test_attention.py)
    "qwen1.5-32b": dict(fsdp=True, kv_quant=True, attn_impl_train="wedge"),
    # yi-6b + fsdp trips an XLA SPMD verifier bug (dynamic-slice through the
    # kv-duplicated attention resharding); at 6B params it doesn't need FSDP.
    "yi-6b": dict(kv_quant=True),
    "pixtral-12b": dict(fsdp=True, kv_quant=True),
    "qwen2-moe-a2.7b": dict(moe_group_axis="data", kv_quant=True),
    "mixtral-8x7b": dict(moe_group_axis="data", kv_quant=True),
    "jamba-1.5-large-398b": dict(moe_group_axis="data",
                                 moe_expert_axis="data", fsdp=True,
                                 kv_quant=True),
}
_TRAIN_ONLY_KEYS = ("layout", "fsdp")
OPT_MICROBATCHES = {
    "olmo-1b": 1, "mamba2-1.3b": 1, "musicgen-large": 1,
    "minitron-8b": 4, "qwen1.5-32b": 8, "yi-6b": 4, "pixtral-12b": 4,
    "qwen2-moe-a2.7b": 4, "mixtral-8x7b": 8, "jamba-1.5-large-398b": 16,
}


def build_cfg(arch: str, mesh_shape: dict, *, opt: bool = False,
              kind: str = "train"):
    """Arch config specialized to a mesh geometry (axis-name -> size dict)."""
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    over = dict(OPT_OVERRIDES.get(arch, {})) if opt else {}
    moe_group_axis = over.pop("moe_group_axis", None)
    moe_expert_axis = over.pop("moe_expert_axis", None)
    if kind != "train":
        for k in _TRAIN_ONLY_KEYS:
            over.pop(k, None)
    cfg = get_arch(arch, tp=tp, **over)
    if cfg.moe is not None:
        groups = dp * tp if cfg.layout in ("dp", "fsdp2d") else dp
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch_groups=groups, group_axis=moe_group_axis,
            expert_axis=moe_expert_axis))
    # pin the batch dim explicitly (perf_log.md iteration 4)
    dp_axes = ("pod", "data") if mesh_shape.get("pod", 1) > 1 else ("data",)
    if cfg.layout in ("dp", "fsdp2d"):
        dp_axes = dp_axes + ("model",)
    return cfg.replace(batch_axes=dp_axes)


def microbatches_for(arch: str, kind: str, opt: bool) -> int:
    if kind != "train":
        return 1
    table = OPT_MICROBATCHES if opt else TRAIN_MICROBATCHES
    return table.get(arch, 1)
