"""DV-DVFS core: the paper's contribution as a composable library.

Pipeline (paper Fig. 3/4):  blocks -> sampling -> estimator -> frequency planner ->
execution (+ energy accounting) — with a Data-Variety-Oblivious (DVO) baseline and
beyond-paper global/roofline planners.

Copied from ``src/repro/core/__init__.py``; every module here is a NumPy copy
of its namesake in ``src/repro/core/``, so plans are bit-identical to the
reference's.
"""
from repro_torch.core.energy import (CPU_PAPER_POWER, DEFAULT_LADDER,
                                     TPU_V5E_POWER, FrequencyLadder,
                                     PowerModel)
from repro_torch.core.estimator import (V5E, ChipSpec, CostModel,
                                        RooflineTerms, RooflineTimeModel)
from repro_torch.core.sampling import (BlockEstimate, required_sample_size,
                                       sample_block_cost, sample_blocks,
                                       sample_blocks_soa)
from repro_torch.core.scheduler import (BlockInfo, BlockPlan, ExecutionReport,
                                        SchedulePlan, block_time,
                                        block_time_table,
                                        block_time_table_arrays,
                                        busy_energy_table, plan_dvfs,
                                        plan_dvfs_arrays, plan_dvo,
                                        plan_dvo_arrays, simulate)
from repro_torch.core.soa import (BlockArrays, EstimateArrays, PlanArrays,
                                  RooflineArrays)
from repro_torch.core.variety import (VarietyStats, variety_stats,
                                      zipf_block_sizes, zipf_weights)

__all__ = [
    "CPU_PAPER_POWER", "DEFAULT_LADDER", "TPU_V5E_POWER", "FrequencyLadder",
    "PowerModel",
    "V5E", "ChipSpec", "CostModel", "RooflineTerms", "RooflineTimeModel",
    "BlockEstimate", "required_sample_size", "sample_block_cost",
    "sample_blocks", "sample_blocks_soa",
    "BlockInfo", "BlockPlan", "ExecutionReport", "SchedulePlan",
    "BlockArrays", "EstimateArrays", "PlanArrays", "RooflineArrays",
    "block_time", "block_time_table", "block_time_table_arrays",
    "busy_energy_table",
    "plan_dvfs", "plan_dvfs_arrays", "plan_dvo", "plan_dvo_arrays",
    "simulate",
    "VarietyStats", "variety_stats", "zipf_block_sizes", "zipf_weights",
]
