"""Data-variety modelling — Zipfian block skew + variety statistics.

Paper §4 ("Modeling data variety"): partitions are ranked by the number of records
satisfying the predicate; the record count of the rank-k partition out of N follows

    f(k; z, N) = (1/k^z) / sum_{n=1..N} (1/n^z)

z = 0 → uniform (no variety), z = 1 → moderate, z = 2 → high variety.

Copied from ``src/repro/core/variety.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["zipf_weights", "zipf_block_sizes", "VarietyStats", "variety_stats"]


def zipf_weights(n: int, z: float) -> np.ndarray:
    """Normalized Zipf weights for ranks 1..n, exponent z (z=0 ⇒ uniform)."""
    if n <= 0:
        raise ValueError("n must be positive")
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-float(z))
    return w / w.sum()


def zipf_block_sizes(
    n_blocks: int,
    total_records: int,
    z: float,
    *,
    min_records: int = 1,
    shuffle: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Split ``total_records`` across ``n_blocks`` with Zipfian skew.

    Every block keeps at least ``min_records`` (a real partition is never empty).
    ``shuffle`` permutes ranks so block order doesn't correlate with cost (the paper's
    blocks are aggregation-order, not rank-order).
    """
    if n_blocks * min_records > total_records:
        raise ValueError("total_records too small for min_records per block")
    w = zipf_weights(n_blocks, z)
    spare = total_records - n_blocks * min_records
    sizes = min_records + np.floor(w * spare).astype(np.int64)
    # distribute rounding remainder to the largest blocks (deterministic)
    remainder = total_records - int(sizes.sum())
    order = np.argsort(-w)
    for i in range(remainder):
        sizes[order[i % n_blocks]] += 1
    if shuffle:
        rng = np.random.default_rng(seed)
        sizes = sizes[rng.permutation(n_blocks)]
    assert sizes.sum() == total_records
    return sizes


@dataclasses.dataclass(frozen=True)
class VarietyStats:
    """Table-1 style statistics of a per-block quantity."""

    mean: float
    variance: float
    cov: float  # coefficient of variation = std / mean
    minimum: float
    maximum: float

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def variety_stats(values: Sequence[float]) -> VarietyStats:
    v = np.asarray(values, dtype=np.float64)
    mean = float(v.mean())
    var = float(v.var())
    cov = float(np.sqrt(var) / mean) if mean > 0 else 0.0
    return VarietyStats(mean=mean, variance=var, cov=cov,
                        minimum=float(v.min()), maximum=float(v.max()))
