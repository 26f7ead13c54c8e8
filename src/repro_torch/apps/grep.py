"""Grep — search & count a token pattern in every record of the block.

Port of ``src/repro/apps/grep.py``: ``run`` on tensors, ``plant`` NumPy as in
the reference (the data generator calls it, so its output stays bitwise the
reference's).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.kernels.ref import row_matches

__all__ = ["Grep"]


@dataclasses.dataclass(frozen=True)
class Grep:
    pattern: tuple = (17, 23, 5)   # token-id pattern, length P
    name: str = "grep"

    def run(self, block, *, device="cuda"):
        tokens = to_device(block["tokens"], device)     # (N, L)
        per_record = row_matches(tokens, self.pattern).to(torch.int32)
        return {"per_record": per_record, "total": per_record.sum()}

    def flops(self, stats: dict) -> float:
        # p comparisons per window position + match-processing per hit
        return 2.0 * len(self.pattern) * stats["tokens"] + 64.0 * stats.get("matches", 0.0)

    def cost_features(self, stats: dict) -> dict:
        return {"tokens": float(stats["tokens"]),
                "matches": float(stats.get("matches", 0.0)), "const": 1.0}

    @staticmethod
    def plant(tokens: np.ndarray, pattern, density: float, seed: int = 0) -> np.ndarray:
        """Plant ``pattern`` into a ``density`` fraction of records (for variety)."""
        rng = np.random.default_rng(seed)
        out = tokens.copy()
        n, length = out.shape
        p = len(pattern)
        k = int(round(density * n))
        rows = rng.choice(n, size=k, replace=False)
        for r in rows:
            pos = rng.integers(0, max(length - p, 1))
            out[r, pos:pos + p] = pattern
        return out
