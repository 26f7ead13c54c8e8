"""Counter-trace format: the calibration subsystem's only input.

A trace is a sequence of per-interval hardware counter samples — the shape
RAPL energy counters or TPU telemetry deliver after windowing:

    (t, dur_s, node, freq, util, energy_j, work_done)

    t          interval start (engine/wall clock, seconds)
    dur_s      interval length (seconds of wall time)
    node       node name (matches ``NodeSpec.name``)
    freq       relative hardware frequency during the interval (0 < f <= 1)
    util       busy utilization during the interval
    energy_j   energy consumed over the interval (busy draw x dur)
    work_done  work completed, in PLANNER units: reference-node seconds at
               f_max.  Fitted speeds are therefore *effective* speeds with
               respect to the planner's estimates — exactly the quantity
               ``NodeSpec.speed`` divides by — so estimate bias and true
               node speed are recalibrated together.

``CounterTrace`` stores a trace as parallel arrays (SoA — one python object
per trace, not per sample); ``TraceRecorder`` is the append-only sink the
runtime engine emits into natively (``RuntimeConfig(trace=...)`` — one
sample per executed block segment, so mid-block frequency switches produce
one sample per frequency).  ``synthetic_trace`` generates traces from known
ground-truth models for fit round-trip tests and the benchmark noise grid.

Copied from ``src/repro/calibrate/trace.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import DEFAULT_LADDER, PowerModel

__all__ = ["CounterSample", "CounterTrace", "TraceRecorder",
           "synthetic_trace"]


@dataclasses.dataclass(frozen=True)
class CounterSample:
    """One counter interval (see module docstring for field semantics)."""

    t: float
    dur_s: float
    node: str
    freq: float
    util: float
    energy_j: float
    work_done: float


@dataclasses.dataclass(frozen=True)
class CounterTrace:
    """SoA counter trace: parallel arrays, one row per interval."""

    t: np.ndarray          # (n,) float64 interval starts
    dur_s: np.ndarray      # (n,) float64 interval lengths
    node: np.ndarray       # (n,) str node names
    freq: np.ndarray       # (n,) float64 relative frequency
    util: np.ndarray       # (n,) float64 busy utilization
    energy_j: np.ndarray   # (n,) float64 energy over the interval
    work_done: np.ndarray  # (n,) float64 planner-unit work completed

    def __post_init__(self):
        n = len(self.t)
        for name in ("dur_s", "node", "freq", "util", "energy_j",
                     "work_done"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"trace field {name} has length "
                                 f"{len(getattr(self, name))}, expected {n}")
        if n and (float(self.dur_s.min()) < 0 or float(self.freq.min()) <= 0):
            raise ValueError("trace needs dur_s >= 0 and freq > 0")

    def __len__(self) -> int:
        return len(self.t)

    @property
    def power_w(self) -> np.ndarray:
        """Observed mean power per interval (0 where the interval is empty)."""
        safe = np.where(self.dur_s > 0, self.dur_s, 1.0)
        return np.where(self.dur_s > 0, self.energy_j / safe, 0.0)

    def freq_residency(self) -> tuple:
        """Seconds spent at each hardware frequency, as sorted
        ``(freq, seconds)`` pairs — the DVFS residency histogram the
        observability exporters and per-node tables reuse (one counter
        sample per executed block segment makes this exact)."""
        if not len(self):
            return ()
        freqs, inv = np.unique(self.freq, return_inverse=True)
        secs = np.bincount(inv, weights=self.dur_s, minlength=len(freqs))
        return tuple((float(f), float(s)) for f, s in zip(freqs, secs))

    def node_names(self) -> tuple:
        """Distinct node names, in first-appearance order."""
        seen: dict = {}
        for nm in self.node.tolist():
            seen.setdefault(nm, None)
        return tuple(seen)

    def for_node(self, name: str) -> "CounterTrace":
        return self.select(self.node == name)

    def select(self, mask) -> "CounterTrace":
        return CounterTrace(self.t[mask], self.dur_s[mask], self.node[mask],
                            self.freq[mask], self.util[mask],
                            self.energy_j[mask], self.work_done[mask])

    @classmethod
    def from_samples(cls, samples) -> "CounterTrace":
        samples = list(samples)
        n = len(samples)
        pull = lambda attr, dt: np.fromiter(
            (getattr(s, attr) for s in samples), dt, count=n)
        return cls(pull("t", np.float64), pull("dur_s", np.float64),
                   np.array([s.node for s in samples], dtype=object),
                   pull("freq", np.float64), pull("util", np.float64),
                   pull("energy_j", np.float64),
                   pull("work_done", np.float64))

    @classmethod
    def concat(cls, parts) -> "CounterTrace":
        parts = [p for p in parts if len(p)]
        if not parts:
            z = np.zeros(0)
            return cls(z, z.copy(), np.array([], dtype=object), z.copy(),
                       z.copy(), z.copy(), z.copy())
        cat = lambda attr: np.concatenate([getattr(p, attr) for p in parts])
        return cls(cat("t"), cat("dur_s"), cat("node"), cat("freq"),
                   cat("util"), cat("energy_j"), cat("work_done"))

    def to_samples(self) -> list:
        return [CounterSample(float(self.t[i]), float(self.dur_s[i]),
                              str(self.node[i]), float(self.freq[i]),
                              float(self.util[i]), float(self.energy_j[i]),
                              float(self.work_done[i]))
                for i in range(len(self))]


class TraceRecorder:
    """Append-only sample sink (what the runtime engine emits into).

    Column lists, one append per sample — ``trace()`` materializes the SoA
    form on demand.  Passing a recorder as ``RuntimeConfig(trace=...)``
    makes the engine emit one sample per executed block *segment* from its
    TELEMETRY/actuator path, so a block split across k frequencies by async
    actuation lands as k samples at their true per-segment frequencies.
    """

    def __init__(self):
        self._cols = tuple([] for _ in range(7))

    def __len__(self) -> int:
        return len(self._cols[0])

    def record(self, t: float, dur_s: float, node: str, freq: float,
               util: float, energy_j: float, work_done: float) -> None:
        for col, v in zip(self._cols, (t, dur_s, node, freq, util, energy_j,
                                       work_done)):
            col.append(v)

    def extend(self, samples) -> None:
        for s in samples:
            self.record(s.t, s.dur_s, s.node, s.freq, s.util, s.energy_j,
                        s.work_done)

    def trace(self) -> CounterTrace:
        t, dur, node, freq, util, energy, work = self._cols
        return CounterTrace(
            np.asarray(t, dtype=np.float64),
            np.asarray(dur, dtype=np.float64),
            np.array(node, dtype=object),
            np.asarray(freq, dtype=np.float64),
            np.asarray(util, dtype=np.float64),
            np.asarray(energy, dtype=np.float64),
            np.asarray(work, dtype=np.float64))


def synthetic_trace(
    node: str,
    power: PowerModel,
    *,
    speed: float = 1.0,
    n_samples: int = 64,
    freqs=DEFAULT_LADDER.states,
    util_range: tuple = (0.6, 1.0),
    mean_work: float = 2.0,
    noise: float = 0.0,
    seed: int = 0,
) -> CounterTrace:
    """Trace generated from known ground truth (fit round-trip harness).

    Each sample runs a lognormal-sized parcel of work at a ladder frequency
    and a uniform utilization; wall time follows the compute-bound model
    ``dur = work / (freq * speed)`` and energy follows ``P(util, freq)``,
    both with multiplicative gaussian noise of relative scale ``noise``
    (clipped so durations/energies stay positive).  Deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    f = rng.choice(np.asarray(freqs, dtype=np.float64), size=n_samples)
    u = rng.uniform(*util_range, size=n_samples)
    work = rng.lognormal(0.0, 0.4, size=n_samples) * mean_work
    jitter = lambda: np.clip(
        1.0 + noise * rng.standard_normal(n_samples), 0.05, None)
    dur = work / (f * speed) * jitter()
    p_true = np.array([power.power(float(uu), float(ff))
                       for uu, ff in zip(u, f)])
    energy = dur * p_true * jitter()
    t = np.concatenate(([0.0], np.cumsum(dur)[:-1]))
    return CounterTrace(t, dur, np.array([node] * n_samples, dtype=object),
                        f, u, energy, work)
