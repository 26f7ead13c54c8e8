"""Node abstraction for cluster-scale DV-DVFS.

A node is one DVFS-capable machine (chip/host/replica) with its own frequency
ladder, power model, and relative throughput.  ``speed`` is the node's
throughput at f_max relative to the reference node used for block estimation:
a block estimated at ``est_time_fmax`` seconds on the reference node takes
``est_time_fmax / speed`` seconds on this node at f_max.

Copied from ``src/repro/cluster/node.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.energy import DEFAULT_LADDER, TPU_V5E_POWER, FrequencyLadder, PowerModel
from repro_torch.core.scheduler import BlockInfo, block_time

__all__ = ["NodeSpec", "CalibratedNodeSpec"]


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One heterogeneous cluster node.

    Attributes:
      name:   stable identifier (used by the simulator and controller).
      speed:  relative throughput at f_max versus the estimation reference.
      ladder: this node's discrete DVFS states (may differ per node).
      power:  this node's power model (may differ per node).
    """

    name: str
    speed: float = 1.0
    ladder: FrequencyLadder = DEFAULT_LADDER
    power: PowerModel = TPU_V5E_POWER

    def __post_init__(self):
        if self.speed <= 0:
            raise ValueError(f"node {self.name}: speed must be positive")

    def block_time(self, block: BlockInfo, rel_freq: float) -> float:
        """PT of ``block`` on this node at ``rel_freq`` (node-local seconds)."""
        return block_time(block, rel_freq) / self.speed

    def block_energy(self, block: BlockInfo, seconds: float,
                     rel_freq: float) -> float:
        """Busy-only energy (paper formula 7) for ``seconds`` on this node."""
        return self.power.busy_energy(seconds, rel_freq, util=block.util)


@dataclasses.dataclass(frozen=True)
class CalibratedNodeSpec(NodeSpec):
    """A ``NodeSpec`` whose speed/power were FITTED from a counter trace
    (``repro.calibrate``) instead of constructed from constants.

    Behaviourally identical to ``NodeSpec`` — every planner and the runtime
    engine accept it wherever a node spec goes — but it keeps the fit
    provenance so reports and re-calibration decisions can see what the
    numbers rest on.  Build via ``repro.calibrate.calibrate_nodes`` (or
    ``plan_cluster(..., calibration=trace)``); ``power_fit``/``speed_fit``
    are ``repro.calibrate.fit`` result objects (either may be None when the
    trace could only identify one half).
    """

    power_fit: object | None = None   # calibrate.fit.PowerFit
    speed_fit: object | None = None   # calibrate.fit.SpeedFit

    @property
    def calibrated(self) -> bool:
        return self.power_fit is not None or self.speed_fit is not None
