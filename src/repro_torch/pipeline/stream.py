"""The chunked SoA dataset→plan path, single-node.

Port of ``src/repro/pipeline/stream.py``.  ``stream_estimates`` drives the
NumPy sampling stage chunk by chunk and accumulates ``EstimateArrays``;
``plan_estimates`` hands the accumulated SoA straight to the vectorized
planner; ``stream_plan`` is the two glued together.
``stream_estimates_tokens`` is the token-blocks front: it picks each
block's sample rows by stateless hash (NumPy, as in the reference), reduces
them on ``device`` with ONE ``block_stats_batched`` launch per chunk (the
kernel's ragged-row masking takes per-block sample sizes), and prices
records with a linear model over the kernel's [nonpad, matches, mass]
features; the per-row decomposition behind the CI runs on the same device.

Multi-node planning (``nodes=``, ``power_cap_w=``), measured calibration
(``PipelineConfig.calibration``) and ``stream_run`` need ``cluster``,
``runtime`` and ``calibrate``, which the port does not hold yet: they raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.energy import (DEFAULT_LADDER, TPU_V5E_POWER,
                                     FrequencyLadder, PowerModel)
from repro_torch.core.sampling import (_DOMAIN_SAMPLER, _hash_uniform,
                                       _z_for_confidence, sample_blocks_soa)
from repro_torch.core.scheduler import plan_dvfs_arrays
from repro_torch.core.soa import EstimateArrays
from repro_torch.device import to_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import row_stats

__all__ = ["PipelineConfig", "stream_estimates", "stream_estimates_tokens",
           "token_chunk_estimates", "plan_estimates", "stream_plan",
           "stream_run", "token_cost", "DEFAULT_TOKEN_COST_WEIGHTS"]

# default linear record-cost model over the kernel's per-row features:
# seconds ≈ w·[nonpad, matches, mass].  Values are arbitrary but fixed —
# benchmarks and tests care about the variety STRUCTURE, not the unit.
DEFAULT_TOKEN_COST_WEIGHTS = (2e-6, 5e-5, 1e-9)

_NO_CLUSTER = ("multi-node planning needs repro_torch.cluster, which the "
               "port does not hold yet (ROADMAP Queue 1 item 1)")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything the dataset→plan path needs, in one place."""

    chunk_size: int = 65536
    # sampling stage
    fraction: float = 0.05
    min_samples: int = 16
    n_boot: int = 200            # exact sampler only (batched CI is analytic)
    confidence: float = 0.95
    seed: int = 0
    sampler: str = "batched"     # "batched" (hot path) | "exact" (oracle)
    # planning stage
    planner: str = "global"
    ladder: FrequencyLadder = DEFAULT_LADDER
    power: PowerModel = TPU_V5E_POWER
    error_margin: float = 0.05
    adaptive_margin: bool = False
    # measured calibration (a CostFit and/or CounterTrace in the reference);
    # must stay None until the port holds repro_torch.calibrate
    calibration: object = None


def token_cost(stats: torch.Tensor, weights=DEFAULT_TOKEN_COST_WEIGHTS
               ) -> torch.Tensor:
    """Seconds at f_max of each row of ``stats`` (..., 3) under the linear
    token model ``w·[nonpad, matches, mass]``, in float64."""
    s = stats.to(torch.float64)
    w = [float(x) for x in weights]
    return s[..., 0] * w[0] + s[..., 1] * w[1] + s[..., 2] * w[2]


def _require_no_calibration(config: PipelineConfig) -> None:
    if config.calibration is not None:
        raise NotImplementedError(
            "PipelineConfig.calibration needs repro_torch.calibrate, which "
            "the port does not hold yet (ROADMAP Queue 1 item 3)")


def _iter_chunks(source, chunk_size: int) -> Iterator[dict]:
    """Normalize a source into chunk dicts of per-record ``costs``."""
    if isinstance(source, np.ndarray):
        if source.ndim != 2:
            raise ValueError("array sources must be 2D (n_blocks, n_records)")
        for start in range(0, len(source), chunk_size):
            yield {"costs": source[start:start + chunk_size]}
        return
    for chunk in source:
        yield chunk


def stream_estimates(source, config: PipelineConfig = PipelineConfig()
                     ) -> EstimateArrays:
    """Sampling stage: chunked per-record costs -> per-block ``EstimateArrays``.

    Each chunk is one ``sample_blocks_soa`` call (global block indices keep
    the draws chunk-invariant); accumulation is a list of SoA parts
    concatenated once — no per-block Python objects anywhere.
    """
    parts = []
    offset = 0
    for chunk in _iter_chunks(source, config.chunk_size):
        costs = np.asarray(chunk["costs"], dtype=np.float64)
        est = sample_blocks_soa(
            costs, chunk.get("lengths"), fraction=config.fraction,
            min_samples=config.min_samples, n_boot=config.n_boot,
            confidence=config.confidence, seed=config.seed,
            start_index=offset, method=config.sampler)
        parts.append(est)
        offset += len(est)
    return EstimateArrays.concat(parts)


def token_chunk_estimates(
    tokens,
    *,
    start_index: int,
    config: PipelineConfig = PipelineConfig(),
    pattern: tuple = (17, 23, 5),
    weights: tuple = DEFAULT_TOKEN_COST_WEIGHTS,
    device="cuda",
) -> EstimateArrays:
    """Estimate one (B, R, L) token chunk: hash-sampled rows through ONE
    batched stats kernel launch, linear cost model, analytic CI.

    Row selection reuses the sampler's stateless hash keyed by global block
    index, so estimates are chunk-size-invariant.  The kernel reduces all
    sampled rows in a single launch (its per-block valid-row masking takes
    the per-block sample sizes); the per-row feature decomposition over
    just the sampled rows prices the CI, on the same device.
    """
    _require_no_calibration(config)
    tokens = to_device(tokens, device)
    if tokens.dtype != torch.int32:
        tokens = tokens.to(torch.int32)
    b, r, length = tokens.shape
    index = start_index + np.arange(b, dtype=np.int64)
    k = np.minimum(r, np.maximum(max(int(config.min_samples), 1),
                                 int(np.ceil(config.fraction * r))))
    k = np.full(b, k, dtype=np.int64)
    kmax = int(k.max()) if b else 0
    if kmax == 0:
        z0 = np.zeros(b)
        return EstimateArrays(index, z0, z0.copy(), z0.copy(), k,
                              np.full(b, r, dtype=np.int64))
    keys = _hash_uniform(config.seed, index[:, None],
                         np.arange(r, dtype=np.int64)[None, :],
                         domain=_DOMAIN_SAMPLER)
    part = np.argpartition(keys, kmax - 1, axis=1)[:, :kmax]
    order = np.argsort(np.take_along_axis(keys, part, axis=1), axis=1,
                       kind="stable")
    sel = torch.from_numpy(np.take_along_axis(part, order, axis=1)).to(
        tokens.device)
    rows = torch.arange(b, device=tokens.device)[:, None]
    sampled = tokens[rows, sel]                        # (B, kmax, L)

    # block-level sampled features: ONE fused kernel launch for the chunk
    stats = ops.block_stats_batched(sampled, k.astype(np.int32),
                                    tuple(pattern), device=tokens.device)
    kt = torch.from_numpy(k).to(tokens.device)
    mean_cost = token_cost(stats, weights) / kt

    # per-row decomposition of the same features -> sample variance -> CI
    cost_r = token_cost(torch.stack(row_stats(sampled, pattern), dim=-1),
                        weights)
    valid = torch.arange(kmax, device=tokens.device)[None, :] < kt[:, None]
    row_mean = torch.where(valid, cost_r, 0.0).sum(dim=1) / kt
    var = (torch.where(valid, cost_r - row_mean[:, None], 0.0) ** 2).sum(
        dim=1) / torch.clamp(kt - 1, min=1)
    hw = _z_for_confidence(config.confidence) * torch.sqrt(var / kt) * r
    total = (mean_cost * r).cpu().numpy()
    hw = hw.cpu().numpy()
    return EstimateArrays(index, total, total - hw, total + hw, k,
                          np.full(b, r, dtype=np.int64))


def stream_estimates_tokens(
    token_chunks: Iterable,
    config: PipelineConfig = PipelineConfig(),
    *,
    pattern: tuple = (17, 23, 5),
    weights: tuple = DEFAULT_TOKEN_COST_WEIGHTS,
    device="cuda",
) -> EstimateArrays:
    """Sampling stage over ``(start, tokens)`` chunks (e.g.
    ``BlockDataset.iter_token_chunks``)."""
    parts = [
        token_chunk_estimates(toks, start_index=start, config=config,
                              pattern=pattern, weights=weights,
                              device=device)
        for start, toks in token_chunks
    ]
    return EstimateArrays.concat(parts)


def plan_estimates(
    est: EstimateArrays,
    deadline_s: float,
    config: PipelineConfig = PipelineConfig(),
    *,
    nodes: Sequence | None = None,
    util: np.ndarray | None = None,
    power_cap_w: float | None = None,
):
    """Planning stage: SoA estimates straight into the vectorized planner
    (``PlanArrays``).  ``nodes`` and ``power_cap_w`` are the reference's
    cluster-plan arguments and raise until the port holds ``cluster``."""
    _require_no_calibration(config)
    if nodes is not None or power_cap_w is not None:
        raise NotImplementedError(_NO_CLUSTER)
    ba = est.to_block_arrays(util=util)
    return plan_dvfs_arrays(ba, deadline_s, planner=config.planner,
                            ladder=config.ladder, power=config.power,
                            error_margin=config.error_margin,
                            adaptive_margin=config.adaptive_margin)


def stream_plan(
    source,
    deadline_s: float,
    config: PipelineConfig = PipelineConfig(),
    *,
    nodes: Sequence | None = None,
):
    """End to end: chunked cost source (or ``EstimateArrays``) ->
    ``PlanArrays``, with no per-block Python objects."""
    est = source if isinstance(source, EstimateArrays) \
        else stream_estimates(source, config)
    return plan_estimates(est, deadline_s, config, nodes=nodes)


def stream_run(source, deadline_s: float,
               config: PipelineConfig = PipelineConfig(), **kwargs):
    """Dataset → plan → event-driven cluster execution in the reference;
    needs ``cluster`` and ``runtime``, which the port does not hold yet."""
    raise NotImplementedError(
        "stream_run needs repro_torch.cluster and repro_torch.runtime, which "
        "the port does not hold yet (ROADMAP Queue 1 items 1-2)")
