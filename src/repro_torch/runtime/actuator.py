"""Async DVFS actuation + exact partial-block accounting + the power ledger.

A real voltage/frequency transition is not free and not instant: the PLL
relocks and the rail settles some ``latency_s`` after the request, and the
transition itself costs ``switch_energy_j``.  The runtime therefore splits a
block into *segments*: each segment runs at one hardware frequency, and a
switch landing mid-block closes the current segment and re-prices only the
remaining work.

Work is measured as a fraction of the block: a segment of ``s`` seconds at
frequency ``f`` completes ``s / T(f)`` of the block, where ``T(f)`` is the
block's true wall time at ``f`` (node-local, slowdown factor included).  By
construction a block split across k frequencies costs

    time   = sum_j  w_j * T(f_j)
    energy = sum_j  w_j * T(f_j) * P(util, f_j)

— exactly the segment sums of ``block_time_table`` / ``busy_energy_table``
scaled by the work fractions (the invariant ``tests/test_runtime.py``
checks from event timestamps alone).

``PowerLedger`` tracks every node's instantaneous draw (idle nodes burn
``p_idle``; a busy node burns ``P(util, f)``) so the engine can refuse any
transition that would push the cluster total over ``power_cap_w``.  Besides
the per-node compute draw it carries an additive *auxiliary* channel
(``add_aux``) for draws that are not the chip itself — today the migration
wire (``repro_torch.runtime.migrate``); aux watts count against the cap exactly
like compute watts.

Copied from ``src/repro/runtime/actuator.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ActuationModel", "InFlight", "PowerLedger"]


@dataclasses.dataclass(frozen=True)
class ActuationModel:
    """How a node's DVFS actuator behaves.

    latency_s:        seconds between a switch *request* and the hardware
                      actually running at the new frequency.  0 == the
                      block-boundary idealization (switches land instantly,
                      so every block runs whole at its planned frequency).
    switch_energy_j:  energy charged to the node per applied transition.
    """

    latency_s: float = 0.0
    switch_energy_j: float = 0.0

    def __post_init__(self):
        if self.latency_s < 0 or self.switch_energy_j < 0:
            raise ValueError("actuation latency/energy must be >= 0")


@dataclasses.dataclass
class InFlight:
    """One block mid-execution on a node.

    ``remaining`` is the work fraction still to run; ``seg_start`` /
    ``seg_time`` describe the current segment (its frequency is the node's
    hardware frequency).  ``generation`` invalidates the scheduled
    BLOCK_FINISH whenever the remainder is re-priced (switch or fault).
    """

    block_pos: int          # position in the node's plan arrays / queue
    block_index: int        # global block index (reporting)
    rel_freq: float         # current segment's hardware frequency
    seg_start: float        # clock time the current segment began
    seg_time: float         # full duration of the remainder at rel_freq
    remaining: float = 1.0  # work fraction not yet completed
    generation: int = 0
    busy_s: float = 0.0     # closed segments' seconds
    energy_j: float = 0.0   # closed segments' joules
    freqs: tuple = ()       # per-segment frequencies, in order
    # closed segments as (start, dur_s, rel_freq, work_frac, energy_j) —
    # what the engine's trace emission turns into CounterSamples; one short
    # tuple per applied mid-block transition, cleared with the block
    seg_log: list = dataclasses.field(default_factory=list)

    def split_at(self, now: float, power, util: float) -> None:
        """Close the current segment at ``now`` (switch/fault landing).

        The elapsed segment seconds convert to completed work via the
        segment's own full-remainder duration; callers then re-price the
        new remainder at the new frequency/factor and bump ``generation``.
        """
        elapsed = now - self.seg_start
        if elapsed < 0:
            raise ValueError("segment cannot close before it started")
        done_frac = self.remaining * (elapsed / self.seg_time) \
            if self.seg_time > 0 else self.remaining
        seg_energy = power.busy_energy(elapsed, self.rel_freq, util=util)
        self.busy_s += elapsed
        self.energy_j += seg_energy
        self.seg_log.append((self.seg_start, elapsed, self.rel_freq,
                             done_frac, seg_energy))
        self.remaining = max(self.remaining - done_frac, 0.0)
        self.seg_start = now


class PowerLedger:
    """Instantaneous per-node draw + cluster total, updated on every change.

    The engine consults ``fits`` before letting a node raise its draw;
    ``peak_w`` is maintained on every change, and the full (time, total)
    timeline is kept only when ``record`` is on (it follows the engine's
    ``log_events`` flag — per-change tuples would dominate memory at the
    million-block scale).
    """

    def __init__(self, idle_draws, cap_w: float | None,
                 record: bool = False, observer=None):
        self._draw = list(idle_draws)   # per-node current watts
        self._idle = list(idle_draws)
        self._aux = [0.0] * len(self._draw)  # additive non-compute watts
        self.total_w = float(sum(self._draw))
        self.cap_w = cap_w
        self.peak_w = self.total_w
        self._record = record
        # streaming observer: called as observer(now, total_w) on every
        # change — the inline metrics feed (repro_torch.obs).  Unlike
        # ``samples`` it holds no per-change memory here; bounding is the
        # observer's job.
        self._obs = observer
        self.samples: list = []         # (time, total_w), when recording

    def draw_of(self, node: int) -> float:
        return self._draw[node]

    def aux_of(self, node: int) -> float:
        return self._aux[node]

    def fits(self, node: int, new_draw: float) -> bool:
        """Would moving ``node`` to ``new_draw`` watts respect the cap?

        Auxiliary draws are part of ``total_w`` and never replaced by a
        compute transition, so they tighten this test automatically.
        """
        if self.cap_w is None:
            return True
        return (self.total_w - self._draw[node] + new_draw
                <= self.cap_w + 1e-9)

    def headroom_w(self) -> float:
        """Watts left under the cap right now (inf when uncapped)."""
        if self.cap_w is None:
            return float("inf")
        return self.cap_w - self.total_w

    def add_aux(self, node: int, dwatts: float, now: float) -> None:
        """Add (or, negative, remove) auxiliary watts on ``node`` — draw
        that is not the chip's compute state, e.g. a migration transfer's
        wire power.  Counts toward the total, the peak, and the cap."""
        self._aux[node] += dwatts
        self.total_w += dwatts
        self.peak_w = max(self.peak_w, self.total_w)
        if self._record:
            self.samples.append((now, self.total_w))
        if self._obs is not None:
            self._obs(now, self.total_w)

    def set_draw(self, node: int, watts: float, now: float) -> None:
        self.total_w += watts - self._draw[node]
        self._draw[node] = watts
        self.peak_w = max(self.peak_w, self.total_w)
        if self._record:
            self.samples.append((now, self.total_w))
        if self._obs is not None:
            self._obs(now, self.total_w)

    def set_idle(self, node: int, now: float) -> None:
        self.set_draw(node, self._idle[node], now)
