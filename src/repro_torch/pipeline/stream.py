"""The chunked SoA dataset→plan path.

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

``plan_estimates(nodes=...)`` plans over a cluster through the copied
``plan_cluster_arrays`` (``power_cap_w`` adds its Σ-power screen), and
``PipelineConfig.calibration`` takes the copied ``repro_torch.calibrate``
fits, as in the reference.  ``stream_run`` hands the cluster plan to the
copied event-driven runtime (``repro_torch.runtime.run_cluster``); the
sampling kernel runs before it, in ``stream_estimates_tokens(...,
device=...)``, so ``stream_run`` itself takes no device.
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
from repro_torch.core.soa import BlockArrays, EstimateArrays
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import row_stats

__all__ = ["PipelineConfig", "stream_estimates", "stream_estimates_tokens",
           "token_chunk_estimates", "plan_estimates", "stream_plan",
           "stream_run", "token_cost", "DEFAULT_TOKEN_COST_WEIGHTS"]

# default linear record-cost model over the kernel's per-row features:
# seconds ≈ w·[nonpad, matches, mass].  Values are arbitrary but fixed —
# benchmarks and tests care about the variety STRUCTURE, not the unit.
DEFAULT_TOKEN_COST_WEIGHTS = (2e-6, 5e-5, 1e-9)

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
    # measured calibration (repro_torch.calibrate) — closes the estimate->
    # plan->measure loop for STREAMED plans:
    #   * a ``CostFit`` prices token blocks with the fitted per-record cost
    #     instead of the linear token model, and stamps every planned block
    #     with the fit's max-form roofline (calibrated memory-bound
    #     fraction), exactly as ``CostFit.roofline()`` would per block;
    #   * a ``CounterTrace`` upgrades the node specs at plan time
    #     (``plan_cluster_arrays(calibration=trace)``);
    #   * a ``(CostFit, CounterTrace)`` tuple applies both.
    calibration: object = None


def token_cost(stats: torch.Tensor, weights=DEFAULT_TOKEN_COST_WEIGHTS
               ) -> torch.Tensor:
    """Seconds at f_max of each row of ``stats`` (..., 3) under the linear
    token model ``w·[nonpad, matches, mass]``, in float64."""
    s = stats.to(torch.float64)
    w = [float(x) for x in weights]
    return s[..., 0] * w[0] + s[..., 1] * w[1] + s[..., 2] * w[2]


def _split_calibration(config: PipelineConfig):
    """-> (CostFit | None, CounterTrace | None) from the config hook."""
    cal = config.calibration
    if cal is None:
        return None, None
    from repro_torch.calibrate.fit import CostFit
    from repro_torch.calibrate.trace import CounterTrace
    if isinstance(cal, CostFit):
        return cal, None
    if isinstance(cal, CounterTrace):
        return None, cal
    if isinstance(cal, tuple) and len(cal) == 2 \
            and isinstance(cal[0], CostFit) \
            and isinstance(cal[1], CounterTrace):
        return cal[0], cal[1]
    raise TypeError("PipelineConfig.calibration must be a CostFit, a "
                    f"CounterTrace, or a (CostFit, CounterTrace) tuple, "
                    f"got {type(cal).__name__}")


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
    dev = resolve_device(device)
    b, r, length = tokens.shape
    index = start_index + np.arange(b, dtype=np.int64)
    fit, _ = _split_calibration(config)
    if fit is not None:
        # calibrated pricing: the fitted per-record cost replaces the
        # linear token model outright — cost is a pure function of record
        # count, so no rows are sampled and no kernel launch runs; the
        # CI halfwidth is the fit's own residual scale
        total = fit.est_time_fmax(np.full(b, float(r)))
        hw = _z_for_confidence(config.confidence) * fit.rmse_s
        return EstimateArrays(index, total, total - hw, total + hw,
                              np.zeros(b, dtype=np.int64),
                              np.full(b, r, dtype=np.int64))
    tokens = to_device(tokens, dev)
    if tokens.dtype != torch.int32:
        tokens = tokens.to(torch.int32)
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
    assignment="auto",
    util: np.ndarray | None = None,
    power_cap_w: float | None = None,
):
    """Planning stage: SoA estimates straight into the vectorized planner.

    Single-node by default (``PlanArrays``); passing ``nodes`` routes the
    same ``BlockArrays`` through ``plan_cluster_arrays``
    (``ClusterPlanArrays``), where ``power_cap_w`` adds the cluster-wide
    Σ-power screen.  ``config.calibration`` applies here: a ``CostFit``
    stamps every block with the fit's calibrated roofline (identical to
    ``CostFit.roofline()`` per block), a ``CounterTrace`` calibrates the
    node specs before the cluster plan.
    """
    fit, trace = _split_calibration(config)
    roofline = fit.roofline_arrays(est.n_records) if fit is not None else None
    ba = est.to_block_arrays(util=util, roofline=roofline)
    if nodes is not None:
        from repro_torch.cluster.planner import plan_cluster_arrays
        return plan_cluster_arrays(ba, nodes, deadline_s,
                                   assignment=assignment,
                                   error_margin=config.error_margin,
                                   power_cap_w=power_cap_w,
                                   calibration=trace)
    if power_cap_w is not None:
        raise ValueError("power_cap_w needs a cluster plan (pass nodes)")
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
    assignment="auto",
):
    """End to end: chunked cost source (or ``EstimateArrays``) ->
    ``PlanArrays``/``ClusterPlanArrays``, with no per-block Python
    objects."""
    est = source if isinstance(source, EstimateArrays) \
        else stream_estimates(source, config)
    return plan_estimates(est, deadline_s, config, nodes=nodes,
                          assignment=assignment)


def stream_run(
    source,
    deadline_s: float,
    config: PipelineConfig = PipelineConfig(),
    *,
    nodes: Sequence,
    assignment="auto",
    truth: BlockArrays | None = None,
    runtime=None,
    events=(),
    power_cap_w: float | None = None,
):
    """Dataset → plan → event-driven execution, SoA end to end.

    The plan→runtime handoff: the accumulated ``EstimateArrays`` become a
    ``ClusterPlanArrays`` (``power_cap_w`` screens the plan) which feeds
    ``repro_torch.runtime.run_cluster`` directly — a million streamed blocks go
    from records to a simulated cluster run without one per-block Python
    object on the planning side.  ``truth`` defaults to the estimates
    themselves (drift-free execution); pass the real costs to study
    estimate error, and ``events``/``runtime`` (a ``RuntimeConfig``) to
    inject faults, migration, actuation latency, or the runtime-side cap.
    """
    from repro_torch.runtime.engine import RuntimeConfig, run_cluster
    est = source if isinstance(source, EstimateArrays) \
        else stream_estimates(source, config)
    cpa = plan_estimates(est, deadline_s, config, nodes=nodes,
                         assignment=assignment, power_cap_w=power_cap_w)
    ba = truth if truth is not None else est.to_block_arrays()
    # default config keeps the event log off: at the million-block scale a
    # per-event tuple log would defeat the pipeline's bounded memory
    if runtime is None:
        cfg = RuntimeConfig(power_cap_w=power_cap_w, log_events=False)
    elif power_cap_w is not None and runtime.power_cap_w is None:
        # the cap must bind at run time too, not just screen the plan
        cfg = dataclasses.replace(runtime, power_cap_w=power_cap_w)
    elif power_cap_w is not None and runtime.power_cap_w != power_cap_w:
        raise ValueError("power_cap_w disagrees with runtime.power_cap_w")
    else:
        cfg = runtime
    return run_cluster(cpa, ba, config=cfg, events=events)
