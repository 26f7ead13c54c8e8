"""Energy / power model — paper formulas (3)-(7) adapted to TPU-class chips.

Paper (DV-DVFS, Ahmadvand et al. 2021), section 3:

    P_i   = (P_full - P_idle) * u_i^CPU + P_idle          (3)
    u_i   = UF_i * u_i^full                               (4)
    UF_i  = PT_i / TS_i                                   (5)
    sum_i TS_i <= Deadline                                (6)
    EC    = sum_i PT_i * P_i                              (7)

The paper's model is frequency-implicit: DVFS enters through the utilization factor
(running slower stretches PT_i toward TS_i) and through the busy-power level.  We keep
the paper-exact form (``paper_block_energy``) and add the explicit frequency-dependent
form used on TPU-class hardware, where dynamic power scales superlinearly with the
clock (P_dyn ∝ f·V², V ≈ affine in f ⇒ P_dyn ∝ f^α, α ≈ 2.4):

    P(u, f) = P_idle + (P_full - P_idle) * u * (f / f_max)^α

Constants are v5e-class *assumptions* (no public per-state curve exists) and are
configurable; the paper's contribution — and what we evaluate — is the policy and the
relative savings.

Copied from ``src/repro/core/energy.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "PowerModel",
    "FrequencyLadder",
    "DEFAULT_LADDER",
    "TPU_V5E_POWER",
]


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Per-chip power model.

    Attributes:
      p_full: busy power (W) at f_max, 100% utilization.
      p_idle: idle power (W) — leakage + static; does not scale with DVFS here
        (conservative: real chips recover a little static power at lower V).
      alpha:  dynamic-power exponent versus relative frequency.
    """

    p_full: float = 200.0
    p_idle: float = 70.0
    alpha: float = 2.4

    def __post_init__(self):
        # A degenerate model (p_full <= p_idle, or a non-positive exponent)
        # makes busy energy non-monotone in the wrong direction: down-clocks
        # then SAVE negative energy, which silently flips the greedy's ΔE
        # sign and turns "lowest feasible frequency" into "highest".  Refuse
        # at construction instead of mis-planning later.
        if self.p_idle <= 0 or self.p_full <= 0:
            raise ValueError(
                f"power levels must be positive, got p_full={self.p_full}, "
                f"p_idle={self.p_idle}")
        if self.p_full <= self.p_idle:
            raise ValueError(
                f"p_full ({self.p_full}) must exceed p_idle ({self.p_idle})"
                " — busy power below idle would make down-clocking cost"
                " negative energy")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be positive, got {self.alpha}")

    def power(self, util: float, rel_freq: float = 1.0) -> float:
        """Chip power (W) at utilization ``util`` and relative frequency ``rel_freq``."""
        util = float(np.clip(util, 0.0, 1.0))
        rel_freq = float(np.clip(rel_freq, 0.0, 1.0))
        return self.p_idle + (self.p_full - self.p_idle) * util * rel_freq**self.alpha

    # --- paper-exact forms -------------------------------------------------
    def paper_block_power(self, pt_i: float, ts_i: float, u_full: float = 1.0) -> float:
        """Formulas (3)-(5): busy power for block i given its slot occupancy."""
        uf_i = 0.0 if ts_i <= 0 else min(pt_i / ts_i, 1.0)
        u_i = uf_i * u_full
        return (self.p_full - self.p_idle) * u_i + self.p_idle

    def paper_energy(self, pts: Sequence[float], tss: Sequence[float]) -> float:
        """Formula (7): EC = sum PT_i * P_i (paper-exact, frequency-implicit)."""
        return float(
            sum(pt * self.paper_block_power(pt, ts) for pt, ts in zip(pts, tss))
        )

    # --- explicit-frequency energies (TPU adaptation) ----------------------
    def busy_energy(self, busy_s: float, rel_freq: float,
                    util: float = 1.0) -> float:
        """Paper's EC term (formula 7): PT_i * P_i — processing energy only."""
        return busy_s * self.power(util, rel_freq)

    def slot_energy(
        self,
        busy_s: float,
        slot_s: float,
        rel_freq: float,
        util: float = 1.0,
    ) -> float:
        """Busy energy + idle power for the slot remainder (full-chip draw).

        The paper's EC (formula 7) is busy-only; this adds the idle tail for
        whole-machine accounting.  E = busy*P(util,f) + max(slot-busy,0)*P_idle.
        """
        idle = max(slot_s - busy_s, 0.0)
        return self.busy_energy(busy_s, rel_freq, util) + idle * self.p_idle


TPU_V5E_POWER = PowerModel(p_full=200.0, p_idle=70.0, alpha=2.4)

# Paper-era CPU (Intel Core-i7 4-core, 2.8 GHz): lower idle share and a steeper
# dynamic curve (voltage headroom: P ∝ f·V², V ≈ affine in f → α ≈ 3).  Used by
# the paper-faithful benchmark rows; the TPU model is used everywhere else.
CPU_PAPER_POWER = PowerModel(p_full=95.0, p_idle=15.0, alpha=3.0)


@dataclasses.dataclass(frozen=True)
class FrequencyLadder:
    """Discrete DVFS states as fractions of f_max, ascending, last == 1.0."""

    states: tuple = tuple(np.round(np.arange(0.50, 1.001, 0.05), 3))

    def __post_init__(self):
        s = tuple(float(x) for x in self.states)
        if not s or abs(s[-1] - 1.0) > 1e-9:
            raise ValueError("ladder must end at 1.0 (f_max)")
        if any(b <= a for a, b in zip(s, s[1:])):
            raise ValueError("ladder must be strictly ascending")
        object.__setattr__(self, "states", s)

    @property
    def f_max(self) -> float:
        return self.states[-1]

    @property
    def f_min(self) -> float:
        return self.states[0]

    def lowest_feasible(self, required_rel_freq: float) -> float:
        """Smallest ladder state >= required_rel_freq (clamped to f_max)."""
        for f in self.states:
            if f >= required_rel_freq - 1e-12:
                return f
        return self.f_max

    def floor_state(self, rel_freq: float) -> float:
        """Largest ladder state <= rel_freq (clamped to f_min)."""
        best = self.states[0]
        for f in self.states:
            if f <= rel_freq + 1e-12:
                best = f
        return best


DEFAULT_LADDER = FrequencyLadder()
