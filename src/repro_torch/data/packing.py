"""Token packing for LM training — block tokens -> fixed (B, S) batches.

Variety surfaces to the trainer as the non-pad fraction of each packed batch; the
DV-DVFS controller consumes exactly that statistic (see train/loop.py).

Copied from ``src/repro/data/packing.py`` (NumPy); held bit-identical to it
by a test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PackedBatch", "pack_tokens"]


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    tokens: np.ndarray        # (B, S) int32
    labels: np.ndarray        # (B, S) int32 — next-token, -1 where invalid
    nonpad_tokens: int

    @property
    def shape(self):
        return self.tokens.shape


def pack_tokens(records: np.ndarray, batch: int, seq_len: int,
                *, eos: int = 1) -> PackedBatch:
    """Greedy-pack variable-length records into (batch, seq_len) rows.

    Records are concatenated with EOS separators row by row; rows are padded with 0.
    """
    rows = np.zeros((batch, seq_len), np.int32)
    b, pos = 0, 0
    for rec in records:
        toks = rec[rec != 0]
        if len(toks) == 0:
            continue
        toks = np.concatenate([toks, [eos]])
        while len(toks) > 0 and b < batch:
            space = seq_len - pos
            take = min(space, len(toks))
            rows[b, pos:pos + take] = toks[:take]
            toks = toks[take:]
            pos += take
            if pos == seq_len:
                b, pos = b + 1, 0
        if b >= batch:
            break
    labels = np.full_like(rows, -1)
    labels[:, :-1] = np.where(rows[:, 1:] != 0, rows[:, 1:], -1)
    return PackedBatch(tokens=rows, labels=labels,
                       nonpad_tokens=int((rows != 0).sum()))
