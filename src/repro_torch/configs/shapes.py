"""The 4 assigned input-shape cells (per-arch applicability in DESIGN.md §4).

  train_4k    : train_step,  seq 4096,    global_batch 256
  prefill_32k : prefill,     seq 32768,   global_batch 32
  decode_32k  : serve_step,  kv 32768,    global_batch 128
  long_500k   : serve_step,  kv 524288,   global_batch 1   (sub-quadratic only)

Copied from ``src/repro/configs/shapes.py``, imports pointed at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

__all__ = ["ShapeCell", "SHAPES", "cell_applicable", "applicable_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> bool:
    """long_500k needs sub-quadratic attention (SSM / hybrid / SWA)."""
    if cell.name == "long_500k":
        return cfg.sub_quadratic
    return True


def applicable_cells(cfg: ArchConfig):
    return [c for c in SHAPES.values() if cell_applicable(cfg, c)]
