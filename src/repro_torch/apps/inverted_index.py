"""InvertedIndex — token -> sorted postings (record, position) for the block.

Port of ``src/repro/apps/inverted_index.py``: a stable ``torch.sort`` and
``torch.searchsorted`` give the same fixed-shape COO arrays (sorted-by-token
order + per-token offsets into the postings) as the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import to_device

__all__ = ["InvertedIndex"]


@dataclasses.dataclass(frozen=True)
class InvertedIndex:
    vocab: int = 32768
    name: str = "inverted_index"

    def run(self, block, *, device="cuda"):
        tokens = to_device(block["tokens"], device)           # (N, L)
        length = tokens.shape[1]
        flat = tokens.reshape(-1)
        # stable sort by token id; PADs (0) sort first and are masked out via offsets
        sorted_tok, order = torch.sort(flat, stable=True)
        rec = torch.div(order, length, rounding_mode="floor").to(torch.int32)
        pos = (order % length).to(torch.int32)
        # postings offsets per token id: searchsorted over the sorted token array
        ids = torch.arange(self.vocab + 1, dtype=flat.dtype, device=flat.device)
        offsets = torch.searchsorted(sorted_tok, ids).to(torch.int32)
        return {"tokens_sorted": sorted_tok, "record": rec, "position": pos,
                "offsets": offsets, "n_valid": (flat != 0).sum()}

    def flops(self, stats: dict) -> float:
        t = stats["tokens_padded"]  # sort runs over the padded block
        return 8.0 * t * max(math.log2(max(t, 2)), 1.0)

    def cost_features(self, stats: dict) -> dict:
        t = float(stats["tokens_padded"])
        return {"tokens_padded_logn": t * max(math.log2(max(t, 2)), 1.0),
                "tokens": float(stats["tokens"]), "const": 1.0}
