"""DV-DVFS controller for training/serving — the paper's loop at step granularity.

Blocks = data blocks; one block packs into one (or more) train steps.  Before an
epoch the controller samples every block (paper Algorithm 1 line 7), estimates the
step cost at f_max via the calibrated CostModel, plans per-block frequencies under
the epoch deadline (the throughput SLO), then actuates per step and accounts energy.

On real hardware ``FrequencyActuator.set`` binds to the platform power-state API;
without one ``SimulatedActuator`` scales recorded step time by the roofline
time model and the energy ledger uses the analytic power model.

Copied from ``src/repro/train/dvfs_controller.py`` (NumPy), imports pointed
at ``repro_torch``; held bit-identical to it by a test.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import (DEFAULT_LADDER, TPU_V5E_POWER, BlockInfo, CostModel,
                        FrequencyLadder, PowerModel, RooflineTimeModel,
                        plan_dvfs, plan_dvo, sample_block_cost)

__all__ = ["SimulatedActuator", "DVFSController", "EnergyLedger"]


class SimulatedActuator:
    """Records the requested frequency; models PT(f) via the roofline model."""

    def __init__(self, roofline: RooflineTimeModel | None = None):
        self.rel_freq = 1.0
        self.roofline = roofline
        self.history: list = []

    def set(self, rel_freq: float):
        self.rel_freq = float(rel_freq)
        self.history.append(self.rel_freq)

    def effective_time(self, measured_fmax_seconds: float) -> float:
        """What the step WOULD take at the current frequency."""
        if self.roofline is not None:
            scale = measured_fmax_seconds / max(self.roofline.time_at(1.0), 1e-12)
            return self.roofline.time_at(self.rel_freq) * scale
        return measured_fmax_seconds / max(self.rel_freq, 1e-6)


@dataclasses.dataclass
class EnergyLedger:
    power: PowerModel = TPU_V5E_POWER
    chips: int = 1
    busy_j: float = 0.0
    time_s: float = 0.0
    steps: int = 0

    def record(self, seconds: float, rel_freq: float, util: float = 1.0):
        self.busy_j += self.chips * self.power.busy_energy(seconds, rel_freq, util)
        self.time_s += seconds
        self.steps += 1

    def summary(self) -> dict:
        return {"busy_j": self.busy_j, "time_s": self.time_s,
                "steps": self.steps,
                "avg_w": self.busy_j / max(self.time_s, 1e-12) / self.chips}


class DVFSController:
    """Plans per-block frequencies for one epoch under a deadline (SLO)."""

    def __init__(self, *, cost_model: CostModel, ladder: FrequencyLadder = DEFAULT_LADDER,
                 power: PowerModel = TPU_V5E_POWER, planner: str = "paper",
                 error_margin: float = 0.05, roofline: RooflineTimeModel | None = None,
                 sample_fraction: float = 0.05, seed: int = 0):
        self.cost_model = cost_model
        self.ladder = ladder
        self.power = power
        self.planner = planner
        self.error_margin = error_margin
        self.roofline = roofline
        self.sample_fraction = sample_fraction
        self.seed = seed
        self.plan = None

    def estimate_blocks(self, per_block_features: Sequence[dict],
                        per_block_record_costs: Sequence[np.ndarray] | None = None
                        ) -> list:
        """BlockInfo per data block from features (+ optional sampled records)."""
        blocks = []
        for i, feats in enumerate(per_block_features):
            t_est = self.cost_model.predict(feats)
            halfwidth = 0.0
            if per_block_record_costs is not None:
                est = sample_block_cost(per_block_record_costs[i],
                                        fraction=self.sample_fraction,
                                        seed=self.seed + i)
                halfwidth = est.rel_halfwidth
            blocks.append(BlockInfo(i, t_est, est_rel_halfwidth=halfwidth,
                                    roofline=self.roofline))
        return blocks

    def make_plan(self, blocks: Sequence[BlockInfo], deadline_s: float):
        self.plan = plan_dvfs(blocks, deadline_s, planner=self.planner,
                              ladder=self.ladder, power=self.power,
                              error_margin=self.error_margin,
                              adaptive_margin=True)
        return self.plan

    def make_dvo_plan(self, blocks: Sequence[BlockInfo], deadline_s: float):
        return plan_dvo(blocks, deadline_s, power=self.power)

    def freq_for_block(self, block_index: int) -> float:
        if self.plan is None:
            return 1.0
        for bp in self.plan.blocks:
            if bp.index == block_index:
                return bp.rel_freq
        return 1.0
