"""Streaming dataset→plan pipeline (port of ``src/repro/pipeline``):

    token chunks ──> hash-sampled rows ──> block_stats_batched (CUDA kernel)
                 ──> EstimateArrays (SoA)
                 ──> plan_dvfs_arrays / plan_cluster_arrays
                 ──> PlanArrays / ClusterPlanArrays

``arrivals`` and ``sources`` are not ported yet.
"""
from repro_torch.pipeline.stream import (DEFAULT_TOKEN_COST_WEIGHTS,
                                         PipelineConfig, plan_estimates,
                                         stream_estimates,
                                         stream_estimates_tokens, stream_plan,
                                         stream_run, token_chunk_estimates,
                                         token_cost)

__all__ = [
    "DEFAULT_TOKEN_COST_WEIGHTS",
    "PipelineConfig",
    "plan_estimates",
    "stream_estimates",
    "stream_estimates_tokens",
    "stream_plan",
    "stream_run",
    "token_chunk_estimates",
    "token_cost",
]
