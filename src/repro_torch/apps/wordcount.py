"""WordCount — count occurrences of every word (token id) in the block.

Port of ``src/repro/apps/wordcount.py``: one ``bincount`` on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import to_device

__all__ = ["WordCount"]


@dataclasses.dataclass(frozen=True)
class WordCount:
    vocab: int = 32768
    name: str = "wordcount"

    def run(self, block, *, device="cuda"):
        tokens = to_device(block["tokens"], device)    # (N, L) int32, 0 = PAD
        counts = torch.bincount(tokens.reshape(-1), minlength=self.vocab)
        counts = counts[:self.vocab].to(torch.int32)
        counts[0] = 0                                  # drop PAD bucket
        return counts

    def flops(self, stats: dict) -> float:
        # one scatter-add + mask per token
        return 4.0 * stats["tokens"]

    def cost_features(self, stats: dict) -> dict:
        return {"tokens": float(stats["tokens"]), "records": float(stats["records"]),
                "const": 1.0}
