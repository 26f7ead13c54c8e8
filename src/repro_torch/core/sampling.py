"""Sampling — discover per-block variety cheaply (Algorithm 1, line 7).

The paper samples each block to estimate its processing requirements, reporting <1 %
overhead for a 5 % error margin at 95 % confidence (their Gapprox lineage).  We
implement the same contract:

  * sample a fraction of each block's records,
  * estimate the block's total cost = mean(sampled per-record cost) * n_records,
  * attach a bootstrap confidence interval so the planner can reserve an error margin
    proportional to the actual estimation uncertainty instead of a fixed fudge.

Copied from ``src/repro/core/sampling.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.soa import EstimateArrays

__all__ = ["BlockEstimate", "sample_block_cost", "sample_blocks",
           "sample_blocks_soa", "required_sample_size"]


@dataclasses.dataclass(frozen=True)
class BlockEstimate:
    """Estimated total cost of one block (seconds, or any additive cost unit)."""

    total: float
    ci_low: float
    ci_high: float
    n_sampled: int
    n_records: int

    @property
    def rel_halfwidth(self) -> float:
        if self.total <= 0:
            return 0.0
        return max(self.total - self.ci_low, self.ci_high - self.total) / self.total


def sample_block_cost(
    record_costs: Sequence[float] | np.ndarray,
    *,
    fraction: float = 0.05,
    min_samples: int = 16,
    n_boot: int = 200,
    confidence: float = 0.95,
    seed: int | np.random.SeedSequence = 0,
    cost_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> BlockEstimate:
    """Estimate the total cost of a block from a sample of its records.

    ``record_costs`` is the per-record cost array (only the sampled entries are
    "looked at" — the caller may pass a lazy array).  ``cost_fn`` optionally maps the
    sampled records to costs (e.g. runs the app on the sample and measures).
    ``seed`` is anything ``np.random.default_rng`` accepts.
    """
    if n_boot < 1:
        raise ValueError("n_boot must be >= 1")
    costs = np.asarray(record_costs, dtype=np.float64)
    n = len(costs)
    if n == 0:
        return BlockEstimate(0.0, 0.0, 0.0, 0, 0)
    rng = np.random.default_rng(seed)
    # k >= 1 whenever the block has records: min_samples=0 with a tiny
    # fraction must not produce an empty sample (mean of zero records is NaN)
    k = min(n, max(min_samples, int(np.ceil(fraction * n)), 1))
    idx = rng.choice(n, size=k, replace=False)
    sampled = costs[idx]
    if cost_fn is not None:
        sampled = np.asarray(cost_fn(sampled), dtype=np.float64)

    est_total = float(sampled.mean() * n)
    # bootstrap CI on the mean: one (n_boot, k) gather instead of an n_boot-
    # iteration python loop.  The generator consumes the identical bit stream
    # either way (row-major fill), so estimates are bit-identical to the loop
    # reference (repro.core._reference.sample_block_cost_reference).
    boots = sampled[rng.integers(0, k, size=(n_boot, k))].mean(axis=1)
    lo_q, hi_q = (1 - confidence) / 2, 1 - (1 - confidence) / 2
    ci_low = float(np.quantile(boots, lo_q) * n)
    ci_high = float(np.quantile(boots, hi_q) * n)
    return BlockEstimate(total=est_total, ci_low=ci_low, ci_high=ci_high,
                         n_sampled=k, n_records=n)


def sample_blocks(
    block_costs: Sequence[Sequence[float] | np.ndarray] | np.ndarray,
    *,
    fraction: float = 0.05,
    min_samples: int = 16,
    n_boot: int = 200,
    confidence: float = 0.95,
    seed: int = 0,
    cost_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> list:
    """Estimate every block of a dataset in one call.

    ``block_costs`` is a sequence of per-record cost arrays (ragged fine) or
    a 2D ``(n_blocks, n_records)`` array.  Block i draws from an rng seeded
    ``SeedSequence((seed, i))``, so estimates are independent of the other
    blocks present and reproducible per block; the loop analogue is
    ``repro.core._reference.sample_blocks_reference``.  Returns a list of
    ``BlockEstimate`` in block order.

    This is the Algorithm-1 "sample every block" pass at dataset scale: the
    vectorized bootstrap keeps per-block work to a handful of array ops, so
    100k blocks estimate in seconds instead of the loop reference's minutes.
    """
    return [
        sample_block_cost(costs, fraction=fraction, min_samples=min_samples,
                          n_boot=n_boot, confidence=confidence,
                          seed=np.random.SeedSequence((seed, i)),
                          cost_fn=cost_fn)
        for i, costs in enumerate(block_costs)
    ]


def _z_for_confidence(confidence: float) -> float:
    """Two-sided z for the given confidence (0.95 → 1.96) via bisection on Φ."""
    from math import erf, sqrt

    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    lo, hi = 0.0, 10.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        p = erf(mid / sqrt(2.0))
        if p < confidence:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def required_sample_size(cov: float, rel_err: float = 0.05,
                         confidence: float = 0.95) -> int:
    """Classic n ≈ (z·CoV/e)² sample size for a mean with relative error ``rel_err``.

    Degenerate inputs are guarded so pipeline callers can feed measured CoVs
    straight in: a zero-variance block (CoV 0) needs exactly one record, a
    non-finite or negative CoV and a non-positive ``rel_err`` are caller bugs
    and raise instead of silently returning NaN-derived sizes.
    """
    if not np.isfinite(cov) or cov < 0.0:
        raise ValueError(f"cov must be finite and >= 0, got {cov}")
    if not rel_err > 0.0:
        raise ValueError(f"rel_err must be positive, got {rel_err}")
    z = _z_for_confidence(confidence)
    n = (z * cov / rel_err) ** 2
    return max(1, int(np.ceil(n)))


# --- hash-keyed SoA sampling (the streamed-pipeline sampler) ----------------

_SM64_MULT1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_MULT2 = np.uint64(0x94D049BB133111EB)

# _hash_uniform domain registry (one per independent consumer of a seed)
_DOMAIN_SAMPLER = 3      # sample-selection keys (here)
_DOMAIN_SYNTH_RECORDS = 1  # repro.pipeline.sources record costs
_DOMAIN_SYNTH_SCALE = 2    # repro.pipeline.sources per-block scales


def _hash_uniform(seed: int, block_index: np.ndarray, slot: np.ndarray,
                  domain: int = 0) -> np.ndarray:
    """Stateless uniforms in [0, 1): a pure function of (seed, domain,
    block, slot).

    splitmix64 finalizer over a (block << 24) ^ slot counter, so every value
    depends only on the GLOBAL block index and the record slot — chunk
    boundaries cannot change the draw (the chunk-size-invariance the
    streamed pipeline's equivalence contract rests on).  Valid for
    ``slot < 2**24`` records per block.

    ``domain`` separates independent consumers sharing one user seed: the
    sampler's selection keys MUST NOT ride the same stream as a hash-based
    data generator, or "pick the k smallest keys" silently becomes "pick
    the k cheapest records" and every estimate is biased low (see
    ``_DOMAIN_*`` constants for the assigned subspaces).
    """
    mix = np.uint64(((int(seed) * 0x9E3779B97F4A7C15)
                     ^ (int(domain) * 0xD1B54A32D192ED03 + 0x632BE59BD9B4E019))
                    & 0xFFFFFFFFFFFFFFFF)
    z = (block_index.astype(np.uint64) << np.uint64(24)) \
        ^ slot.astype(np.uint64)
    # finalize in-place and in cache-sized tiles: the hash runs over 10^8-
    # element batches in the million-block pipeline, where whole-array
    # temporaries turn a compute kernel into a memory-bandwidth one
    out = np.empty(z.shape, dtype=np.float64)
    zf = z.reshape(-1)
    of = out.reshape(-1)
    tile = 1 << 17
    tmp = np.empty(min(tile, zf.size), dtype=np.uint64)
    for s in range(0, zf.size, tile):
        v = zf[s:s + tile]
        t = tmp[:len(v)]
        v += mix
        np.right_shift(v, np.uint64(30), out=t)
        v ^= t
        v *= _SM64_MULT1
        np.right_shift(v, np.uint64(27), out=t)
        v ^= t
        v *= _SM64_MULT2
        np.right_shift(v, np.uint64(31), out=t)
        v ^= t
        v >>= np.uint64(11)
        np.multiply(v, 1.0 / (1 << 53), out=of[s:s + tile])
    return out


def sample_blocks_soa(
    costs: np.ndarray,
    lengths: np.ndarray | None = None,
    *,
    fraction: float = 0.05,
    min_samples: int = 16,
    n_boot: int = 200,
    confidence: float = 0.95,
    seed: int = 0,
    start_index: int = 0,
    method: str = "batched",
) -> EstimateArrays:
    """Estimate a whole chunk of blocks with zero per-block Python objects.

    ``costs`` is a dense ``(n_blocks, n_records)`` per-record cost array;
    ``lengths`` gives each block's real record count for ragged chunks packed
    into the common width (records at or beyond a block's length are never
    looked at).  ``start_index`` is the first block's GLOBAL index — all
    randomness keys off (seed, global index), so splitting a dataset into
    different chunk sizes yields identical estimates.

    ``method="batched"`` (the hot path) selects each block's ``k`` sample
    records by smallest hash key (exact without-replacement sampling, one
    vectorized pass for the whole chunk) and attaches the analytic normal CI
    ``mean ± z·s/√k`` instead of the bootstrap — the bootstrap's
    ``n_boot × k`` work per block is what the object path spends most of its
    time on, and at a million blocks it alone would cost minutes.  Degenerate
    blocks are safe by construction: single-record and zero-variance blocks
    get a zero-width CI, empty blocks a zero estimate — never NaN.

    ``method="exact"`` reproduces ``sample_blocks`` bit for bit (same
    per-block ``SeedSequence((seed, global_index))`` streams, same bootstrap
    quantiles) while still returning SoA output — the equivalence-oracle
    bridge between the streamed pipeline and the object path.
    """
    costs = np.asarray(costs, dtype=np.float64)
    if costs.ndim != 2:
        raise ValueError(f"costs must be 2D (n_blocks, n_records), "
                         f"got shape {costs.shape}")
    b, r = costs.shape
    index = start_index + np.arange(b, dtype=np.int64)
    if lengths is None:
        n = np.full(b, r, dtype=np.int64)
    else:
        n = np.asarray(lengths, dtype=np.int64)
        if n.shape != (b,) or np.any(n < 0) or np.any(n > r):
            raise ValueError("lengths must be (n_blocks,) within [0, n_records]")

    if method == "exact":
        total = np.zeros(b)
        ci_low = np.zeros(b)
        ci_high = np.zeros(b)
        k_out = np.zeros(b, dtype=np.int64)
        for j in range(b):
            est = sample_block_cost(
                costs[j, :n[j]], fraction=fraction, min_samples=min_samples,
                n_boot=n_boot, confidence=confidence,
                seed=np.random.SeedSequence((seed, int(index[j]))))
            total[j] = est.total
            ci_low[j] = est.ci_low
            ci_high[j] = est.ci_high
            k_out[j] = est.n_sampled
        return EstimateArrays(index, total, ci_low, ci_high, k_out, n)
    if method != "batched":
        raise ValueError(f"unknown sampling method: {method}")

    # same size rule as sample_block_cost (k >= 1 wherever a record exists;
    # empty blocks keep k == 0)
    k = np.minimum(n, np.maximum(max(int(min_samples), 1),
                                 np.ceil(fraction * n).astype(np.int64)))
    kmax = int(k.max()) if b else 0
    if kmax == 0:
        z0 = np.zeros(b)
        return EstimateArrays(index, z0, z0.copy(), z0.copy(),
                              k, n)
    slots = np.arange(r, dtype=np.int64)
    keys = _hash_uniform(seed, index[:, None], slots[None, :],
                         domain=_DOMAIN_SAMPLER)
    uniform = lengths is None and int(k.min()) == kmax
    if not uniform:
        keys = np.where(slots[None, :] < n[:, None], keys, np.inf)
    # exact without-replacement sample: each block's k smallest keys
    if kmax < r:
        part = np.argpartition(keys, kmax - 1, axis=1)[:, :kmax]
    else:
        part = np.broadcast_to(slots[None, :], (b, r))
    if uniform:
        # every block samples exactly kmax records: the k-smallest SET is all
        # that matters for mean/variance, so skip the within-row sort+mask
        sampled = np.take_along_axis(costs, part, axis=1)
        mean = sampled.mean(axis=1)
        var = ((sampled - mean[:, None]) ** 2).sum(axis=1) / max(kmax - 1, 1)
        ksafe = np.float64(kmax)
    else:
        order = np.argsort(np.take_along_axis(keys, part, axis=1), axis=1,
                           kind="stable")
        sel = np.take_along_axis(part, order, axis=1)
        sampled = np.take_along_axis(costs, sel, axis=1)
        m = np.arange(kmax)[None, :] < k[:, None]
        ksafe = np.maximum(k, 1).astype(np.float64)
        mean = np.where(m, sampled, 0.0).sum(axis=1) / ksafe
        resid = np.where(m, sampled - mean[:, None], 0.0)
        var = (resid ** 2).sum(axis=1) / np.maximum(k - 1, 1)
    se = np.sqrt(var / ksafe)
    hw = _z_for_confidence(confidence) * se * n
    total = mean * n
    return EstimateArrays(index, total, total - hw, total + hw, k, n)
