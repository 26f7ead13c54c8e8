"""Block dataset — equal-size blocks with Zipf-distributed work (paper §4).

Blocks have identical SHAPE (records × max_len) — what varies is content:
  * non-pad token counts (source mixture drifts block-to-block),
  * predicate-match density, ranked Zipf(z) across blocks (paper's variety model).

The paper: "partitions are ranked as per the number of records in the partition that
satisfy the given predicate", frequency ∝ 1/k^z.

Port of ``src/repro/data/blocks.py``.  Generation is NumPy, as in the
reference, so ``block(i)`` is bitwise the reference's; ``iter_token_chunks``
and ``stats_soa`` move each chunk to ``device`` once, and ``stats_soa``
reduces it with one ``block_stats_batched`` launch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.variety import zipf_weights
from repro_torch.data.synth import SOURCES, make_corpus_block
from repro_torch.device import resolve_device

__all__ = ["BlockStats", "BlockDataset"]


@dataclasses.dataclass(frozen=True)
class BlockStats:
    """Cheap per-block statistics (what sampling is allowed to see in full)."""

    records: int
    tokens: int           # non-pad tokens
    tokens_padded: int
    matches: int          # grep pattern occurrences
    selected: int         # predicate-selected records (AVG/SUM)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BlockDataset:
    """Deterministic, lazily-generated blocks."""

    n_blocks: int = 32
    records_per_block: int = 2048
    max_len: int = 256
    vocab: int = 32768
    variety_z: float = 1.0      # Zipf exponent across blocks (0 = uniform)
    grep_pattern: tuple = (17, 23, 5)
    seed: int = 0
    base_match_density: float = 0.02
    max_match_density: float = 0.60

    def _mix(self, rng: np.random.Generator) -> np.ndarray:
        """Per-block source mixture (drifts block to block — aggregation order)."""
        return rng.dirichlet(np.ones(len(SOURCES)) * 1.5)

    def match_densities(self) -> np.ndarray:
        """Zipf-ranked predicate densities, shuffled to aggregation order.

        Cached: ``block(i)`` reads one entry per call, and recomputing the
        whole Zipf ranking per block turns chunked iteration quadratic.
        """
        cached = self.__dict__.get("_densities")
        if cached is not None:
            return cached
        w = zipf_weights(self.n_blocks, self.variety_z)
        d = self.base_match_density + (self.max_match_density
                                       - self.base_match_density) * w / w.max()
        rng = np.random.default_rng(self.seed + 7)
        d = d[rng.permutation(self.n_blocks)]
        self.__dict__["_densities"] = d
        return d

    def block(self, i: int, *, with_tokens: bool = True) -> dict:
        """Materialize block i: tokens + numeric columns + predicate.

        ``with_tokens=False`` skips corpus generation (for the numeric-only
        AVG/SUM apps, whose variety lives in the predicate column).
        """
        if not 0 <= i < self.n_blocks:
            raise IndexError(i)
        rng = np.random.default_rng((self.seed, i))
        density = float(self.match_densities()[i])
        out = {}
        if with_tokens:
            tokens = make_corpus_block(self.records_per_block, self.max_len,
                                       self.vocab, self._mix(rng), rng=rng)
            # plant grep pattern into `density` fraction of records
            from repro_torch.apps.grep import Grep
            tokens = Grep.plant(tokens, self.grep_pattern, density,
                                seed=int(rng.integers(2**31)))
            out["tokens"] = tokens
        n = self.records_per_block
        out["values"] = rng.gamma(2.0, 50.0, size=n).astype(np.float32)
        out["group"] = rng.integers(0, 8, size=n).astype(np.int32)
        out["select"] = rng.random(n) < density
        return out

    def stats(self, i: int) -> BlockStats:
        b = self.block(i)
        tokens = b["tokens"]
        pat = np.asarray(self.grep_pattern)
        p = len(pat)
        win = np.ones((tokens.shape[0], tokens.shape[1] - p + 1), bool)
        for j in range(p):
            win &= tokens[:, j:tokens.shape[1] - p + 1 + j] == pat[j]
        return BlockStats(
            records=tokens.shape[0],
            tokens=int((tokens != 0).sum()),
            tokens_padded=int(tokens.size),
            matches=int(win.sum()),
            selected=int(b["select"].sum()),
        )

    def iter_token_chunks(self, chunk_size: int = 256, *, device="cuda"
                          ) -> Iterator[tuple]:
        """Yield ``(start, tokens)`` with ``tokens`` a (B, R, L) int32 tensor
        on ``device``.

        The chunked feed for the streaming pipeline and the batched stats
        kernel: blocks are materialized ``chunk_size`` at a time, never the
        whole dataset (bounded memory at large ``n_blocks``), and each chunk
        is copied to the device once.  The device is checked at the call.
        """
        dev = resolve_device(device)
        return ((start, self._token_stack(
                    self.block(i) for i in range(
                        start, min(start + chunk_size, self.n_blocks))).to(dev))
                for start in range(0, self.n_blocks, chunk_size))

    @staticmethod
    def _token_stack(blocks) -> torch.Tensor:
        """(B, R, L) int32 CPU tensor of the given block dicts' tokens."""
        return torch.from_numpy(np.stack([b["tokens"] for b in blocks])
                                .astype(np.int32, copy=False))

    def stats_soa(self, chunk_size: int = 256, *, device="cuda") -> dict:
        """All blocks' ``BlockStats`` as SoA arrays via the batched kernel.

        One ``block_stats_batched`` launch per chunk computes every block's
        [nonpad, matches, mass] in a single fused pass
        (``repro_torch.kernels.block_stats``); ``selected`` comes from the
        predicate column directly.  Returns a dict of (n_blocks,) arrays
        with the same fields as ``stats(i)`` plus ``mass`` — and never
        builds a ``BlockStats`` object.
        """
        from repro_torch.kernels import ops
        dev = resolve_device(device)
        n = self.n_blocks
        out = {
            "records": np.full(n, self.records_per_block, dtype=np.int64),
            "tokens": np.zeros(n, dtype=np.int64),
            "tokens_padded": np.full(
                n, self.records_per_block * self.max_len, dtype=np.int64),
            "matches": np.zeros(n, dtype=np.int64),
            "selected": np.zeros(n, dtype=np.int64),
            "mass": np.zeros(n, dtype=np.float64),
        }
        for start in range(0, n, chunk_size):
            stop = min(start + chunk_size, n)
            blocks = [self.block(i) for i in range(start, stop)]
            toks = self._token_stack(blocks).to(dev)
            stats = ops.block_stats_batched(
                toks, pattern=self.grep_pattern, device=dev).cpu().numpy()
            out["tokens"][start:stop] = stats[:, 0].astype(np.int64)
            out["matches"][start:stop] = stats[:, 1].astype(np.int64)
            out["mass"][start:stop] = stats[:, 2].astype(np.float64)
            out["selected"][start:stop] = [int(b["select"].sum())
                                           for b in blocks]
        return out

    def __iter__(self) -> Iterator[dict]:
        for i in range(self.n_blocks):
            yield self.block(i)
