"""Streaming dataset→plan pipeline (port of ``src/repro/pipeline``):

    token chunks ──> hash-sampled rows ──> block_stats_batched (CUDA kernel)
                 ──> EstimateArrays (SoA)
                 ──> plan_dvfs_arrays / plan_cluster_arrays
                 ──> PlanArrays / ClusterPlanArrays

``arrivals`` (seeded multi-tenant job arrivals for ``repro_torch.serving``)
and ``sources`` (chunk-size-invariant synthetic cost chunks) are copies of
the reference's modules; ``stream_run`` hands a cluster plan to
``repro_torch.runtime``.
"""
from repro_torch.pipeline.arrivals import (ArrivalSpec, JobArrival,
                                           TenantSpec, generate_arrivals)
from repro_torch.pipeline.sources import synthetic_cost_chunks
from repro_torch.pipeline.stream import (DEFAULT_TOKEN_COST_WEIGHTS,
                                         PipelineConfig, plan_estimates,
                                         stream_estimates,
                                         stream_estimates_tokens, stream_plan,
                                         stream_run, token_chunk_estimates,
                                         token_cost)

__all__ = [
    "ArrivalSpec",
    "DEFAULT_TOKEN_COST_WEIGHTS",
    "JobArrival",
    "PipelineConfig",
    "TenantSpec",
    "generate_arrivals",
    "plan_estimates",
    "stream_estimates",
    "stream_estimates_tokens",
    "stream_plan",
    "stream_run",
    "synthetic_cost_chunks",
    "token_chunk_estimates",
    "token_cost",
]
