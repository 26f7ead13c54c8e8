"""Synthetic multi-source corpus — the paper's aggregation-of-sources setting.

The paper aggregates IMDB + Quotes + StackOverflow comments + Gutenberg; the sources
differ in record length and vocabulary skew, which is exactly what produces the
variety in Figs. 1-2.  We model each source by (mean record length, length
dispersion, vocabulary Zipf exponent) and generate reproducible token records.

Copied from ``src/repro/data/synth.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SourceSpec", "SOURCES", "make_corpus_block"]


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    name: str
    mean_len: int       # mean tokens per record
    len_sigma: float    # lognormal dispersion of record length
    vocab_z: float      # Zipf exponent of the token distribution

    def sample_records(self, n: int, max_len: int, vocab: int,
                       rng: np.random.Generator) -> np.ndarray:
        lens = np.clip(
            rng.lognormal(np.log(self.mean_len), self.len_sigma, size=n),
            1, max_len).astype(np.int64)
        # Zipfian token draw via inverse-CDF (vectorized): ids 1..vocab-1, 0=PAD
        ranks = np.arange(1, vocab, dtype=np.float64)
        w = ranks ** (-self.vocab_z)
        cdf = np.cumsum(w / w.sum())
        total = int(lens.sum())
        draws = (np.searchsorted(cdf, rng.random(total)) + 1).astype(np.int32)
        out = np.zeros((n, max_len), np.int32)
        mask = np.arange(max_len)[None, :] < lens[:, None]
        out[mask] = draws  # row-major fill matches per-record lengths
        return out


# Analogues of the paper's four text sources (IMDB, Quotes, Comments, Gutenberg):
SOURCES = (
    SourceSpec("imdb", mean_len=48, len_sigma=0.5, vocab_z=1.1),
    SourceSpec("quotes", mean_len=16, len_sigma=0.4, vocab_z=1.3),
    SourceSpec("comments", mean_len=96, len_sigma=0.9, vocab_z=1.0),
    SourceSpec("gutenberg", mean_len=192, len_sigma=0.3, vocab_z=0.9),
)


def make_corpus_block(
    n_records: int,
    max_len: int,
    vocab: int,
    source_mix: np.ndarray,
    *,
    rng: np.random.Generator,
    sources: tuple = SOURCES,
) -> np.ndarray:
    """One equal-size block: ``n_records`` records drawn from a source mixture."""
    counts = rng.multinomial(n_records, source_mix / source_mix.sum())
    parts = [s.sample_records(c, max_len, vocab, rng)
             for s, c in zip(sources, counts) if c > 0]
    tokens = np.concatenate(parts, axis=0)
    return tokens[rng.permutation(len(tokens))]
