"""Chunk sources for the streaming pipeline.

A *source* is anything ``stream_estimates`` can iterate: a generator of
chunk dicts (``{"costs": (B, R) float64[, "lengths": (B,)]}``), or a single
dense 2D array (sliced into chunks internally).  Sources must be
chunk-size-invariant: the records a block carries may depend only on the
block's GLOBAL index, never on which chunk it landed in — that is what lets
the equivalence suite re-run the same dataset under random chunk sizes and
demand identical plans.

Copied from ``src/repro/pipeline/sources.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.sampling import (_DOMAIN_SYNTH_RECORDS, _DOMAIN_SYNTH_SCALE,
                                 _hash_uniform)

__all__ = ["synthetic_cost_chunks"]


def synthetic_cost_chunks(
    n_blocks: int,
    records_per_block: int = 64,
    *,
    z: float = 1.0,
    mean_cost: float = 5.0,
    seed: int = 0,
    chunk_size: int = 65536,
) -> Iterator[dict]:
    """Deterministic synthetic per-record costs, one chunk at a time.

    Each block draws a heavy-tailed scale (Zipf-like skew controlled by
    ``z``; ``z=0`` is uniform) and Exp(1) per-record costs, all from the
    stateless (seed, global block index, record slot) hash — so generation
    is O(chunk) memory, embarrassingly chunkable, and yields bit-identical
    records for any ``chunk_size``.  This is the million-block feed for
    ``benchmarks/run.py --section pipeline``.

    All draws live in hash domains disjoint from the sampler's selection
    keys, so sharing one ``seed`` between source and pipeline config (the
    natural call) cannot correlate which records exist with which records
    get sampled.
    """
    slots = np.arange(records_per_block, dtype=np.int64)
    for start in range(0, n_blocks, chunk_size):
        b = min(chunk_size, n_blocks - start)
        gi = np.arange(start, start + b, dtype=np.int64)
        if z > 0:
            u_b = _hash_uniform(seed, gi, np.zeros(b, np.int64),
                                domain=_DOMAIN_SYNTH_SCALE)
            # truncated Pareto tail: skew grows with z, mean stays finite
            scale = mean_cost * np.minimum((1.0 - u_b) ** (-0.5 * z), 50.0)
        else:
            scale = np.full(b, mean_cost)
        u_r = _hash_uniform(seed, gi[:, None], slots[None, :],
                            domain=_DOMAIN_SYNTH_RECORDS)
        yield {"costs": scale[:, None] * (-np.log1p(-u_r))}
