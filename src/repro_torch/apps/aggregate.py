"""AVG (TPC-H analogue) and SUM (Amazon-reviews analogue) aggregations.

Blocks carry numeric columns next to the tokens:
  * ``values``  (N,) float32 — e.g. l_extendedprice / review rating,
  * ``group``   (N,) int32   — e.g. shipmode bucket / product bucket,
  * ``select``  (N,) bool    — predicate (the Zipf-varied quantity).

Port of ``src/repro/apps/aggregate.py``: group sums with ``index_add_``.  On
the card the adds run in no fixed order, so float sums agree with the
reference to rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import to_device

__all__ = ["Average", "Sum"]


def _columns(block, device) -> tuple:
    """-> (values, group as int64, select as the values' dtype) on ``device``."""
    v = to_device(block["values"], device)
    g = to_device(block["group"], device).to(torch.int64)
    m = to_device(block["select"], device).to(v.dtype)
    return v, g, m


@dataclasses.dataclass(frozen=True)
class Average:
    n_groups: int = 8
    name: str = "avg"

    def run(self, block, *, device="cuda"):
        v, g, m = _columns(block, device)
        sums = torch.zeros(self.n_groups, dtype=v.dtype, device=v.device)
        cnts = torch.zeros(self.n_groups, dtype=v.dtype, device=v.device)
        sums.index_add_(0, g, v * m)
        cnts.index_add_(0, g, m)
        return sums / torch.clamp(cnts, min=1.0)

    def flops(self, stats: dict) -> float:
        return 6.0 * stats["records"] + 32.0 * stats.get("selected", 0.0)

    def cost_features(self, stats: dict) -> dict:
        return {"records": float(stats["records"]),
                "selected": float(stats.get("selected", 0.0)), "const": 1.0}


@dataclasses.dataclass(frozen=True)
class Sum:
    n_groups: int = 8
    name: str = "sum"

    def run(self, block, *, device="cuda"):
        v, g, m = _columns(block, device)
        sums = torch.zeros(self.n_groups, dtype=v.dtype, device=v.device)
        return sums.index_add_(0, g, v * m)

    def flops(self, stats: dict) -> float:
        return 4.0 * stats["records"] + 16.0 * stats.get("selected", 0.0)

    def cost_features(self, stats: dict) -> dict:
        return {"records": float(stats["records"]),
                "selected": float(stats.get("selected", 0.0)), "const": 1.0}
