"""Open-loop arrival streams — the pipeline's time dimension.

Every source so far described a *closed* batch: a block set that exists in
full before planning starts.  Production big-data traffic is an open loop:
jobs (small block sets) arrive continuously from many tenants, each job
with its own deadline (``arrival + tenant SLO``) and its tenant's priority.
``ArrivalSpec`` describes that traffic; ``generate_arrivals`` expands it
into a deterministic, totally ordered schedule of ``JobArrival`` records
that the serving fabric (``repro_torch.serving``) feeds to the runtime engine as
``JOB_ARRIVAL`` events.

Determinism discipline (same contract as ``sources.synthetic_cost_chunks``):
the schedule is a pure function of the spec — per-tenant substreams seed
from ``SeedSequence([seed, tenant_position])``, so adding a tenant never
perturbs another tenant's draws, and two runs of the same spec are
identical bit for bit.

Arrival processes (per tenant):
  * ``poisson`` — homogeneous rate ``rate_hz`` over the horizon;
  * ``burst``   — Poisson base rate plus an extra Poisson stream at
    ``rate_hz * (burst_factor - 1)`` inside ``[burst_start_s, burst_end_s)``
    (piecewise-constant intensity, exact by superposition);
  * ``trace``   — explicit arrival times (replayed measurements).

Copied from ``src/repro/pipeline/arrivals.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TenantSpec", "ArrivalSpec", "JobArrival", "generate_arrivals"]

_PROCESSES = ("poisson", "burst", "trace")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic contract.

    rate_hz:       mean job arrival rate (jobs/second; ignored for
                   ``process="trace"``);
    slo_s:         per-job deadline, seconds after arrival;
    priority:      shedding value weight — higher survives longer.  Ties
                   across tenants are rejected (``ArrivalSpec``): the
                   shed order between tied tenants would be an accident
                   of job numbering, not a policy;
    blocks_per_job: inclusive (lo, hi) block-count range per job;
    block_time_s:  (lo, hi) uniform range of per-block est seconds at f_max;
    records_per_block: data size stamped on each block (0 = unknown);
    process:       arrival process kind (see module doc);
    burst_factor:  rate multiplier inside the burst window (``burst``);
    burst_start_s / burst_end_s: the burst window (``burst``);
    trace_times_s: explicit arrival times (``trace``).
    """

    name: str
    rate_hz: float
    slo_s: float
    priority: float = 1.0
    blocks_per_job: tuple = (1, 3)
    block_time_s: tuple = (2.0, 6.0)
    records_per_block: float = 0.0
    process: str = "poisson"
    burst_factor: float = 1.0
    burst_start_s: float = 0.0
    burst_end_s: float = 0.0
    trace_times_s: tuple = ()

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.process not in _PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r} "
                             f"(one of {_PROCESSES})")
        if not np.isfinite(self.rate_hz) or self.rate_hz < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate_hz must be finite and >= 0, "
                f"got {self.rate_hz!r} — a negative rate silently starves "
                f"the tenant")
        if not self.slo_s > 0:
            raise ValueError(
                f"tenant {self.name!r}: slo_s must be positive, got "
                f"{self.slo_s!r} — a non-positive SLO rejects every job "
                f"at arrival")
        if not np.isfinite(self.priority) or self.priority < 0:
            raise ValueError(f"tenant {self.name!r}: priority must be "
                             f"finite and >= 0, got {self.priority!r}")
        lo, hi = self.blocks_per_job
        if not (isinstance(lo, int) and isinstance(hi, int)
                and 1 <= lo <= hi):
            raise ValueError(f"tenant {self.name!r}: blocks_per_job must "
                             f"be ints with 1 <= lo <= hi, got "
                             f"{self.blocks_per_job!r}")
        tlo, thi = self.block_time_s
        if not (0 < tlo <= thi):
            raise ValueError(f"tenant {self.name!r}: block_time_s must "
                             f"satisfy 0 < lo <= hi, got "
                             f"{self.block_time_s!r}")
        if self.records_per_block < 0:
            raise ValueError(f"tenant {self.name!r}: records_per_block "
                             f"must be >= 0")
        if self.process == "burst":
            if not self.burst_factor >= 1.0:
                raise ValueError(f"tenant {self.name!r}: burst_factor must "
                                 f"be >= 1 (1 == no burst), got "
                                 f"{self.burst_factor!r}")
            if not 0 <= self.burst_start_s <= self.burst_end_s:
                raise ValueError(
                    f"tenant {self.name!r}: burst window needs "
                    f"0 <= start <= end, got "
                    f"[{self.burst_start_s!r}, {self.burst_end_s!r})")
        if self.process == "trace":
            ts = np.asarray(self.trace_times_s, dtype=np.float64)
            if len(ts) and (not np.all(np.isfinite(ts))
                            or float(ts.min()) < 0
                            or bool(np.any(np.diff(ts) < 0))):
                raise ValueError(f"tenant {self.name!r}: trace_times_s must "
                                 f"be finite, non-negative, and sorted")


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """A full traffic mix: tenants + horizon + seed."""

    tenants: tuple
    horizon_s: float
    seed: int = 0

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("ArrivalSpec needs at least one tenant")
        for tn in self.tenants:
            if not isinstance(tn, TenantSpec):
                raise TypeError(f"tenants must be TenantSpec, got {tn!r}")
        names = [tn.name for tn in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        prios = [tn.priority for tn in self.tenants]
        if len(set(prios)) != len(prios):
            raise ValueError(
                f"tenant priority tie: {sorted(prios)} — the shedding "
                f"order between tied tenants would be arbitrary; make "
                f"priorities distinct")
        if not np.isfinite(self.horizon_s) or not self.horizon_s > 0:
            raise ValueError(f"horizon_s must be positive and finite, got "
                             f"{self.horizon_s!r}")


@dataclasses.dataclass(frozen=True)
class JobArrival:
    """One job in the expanded schedule: ``block_times`` are per-block est
    seconds at f_max; global block indices are assigned by the consumer
    (the serving fabric numbers them past the closed-batch plan)."""

    job_id: int
    tenant: str
    priority: float
    time: float
    deadline_s: float       # time + tenant slo
    block_times: tuple
    records_per_block: float = 0.0


def _poisson_times(rng, rate_hz: float, t0: float, t1: float) -> list:
    """Homogeneous Poisson arrival times in [t0, t1): exponential gaps."""
    if rate_hz <= 0 or t1 <= t0:
        return []
    out: list = []
    t = t0
    while True:
        t += float(rng.exponential(1.0 / rate_hz))
        if t >= t1:
            return out
        out.append(t)


def generate_arrivals(spec: ArrivalSpec) -> tuple:
    """Expand an ``ArrivalSpec`` into a sorted ``JobArrival`` schedule.

    Total order: ``(time, -priority, tenant name)`` — simultaneous arrivals
    admit the higher-priority tenant first, never in input order.  Job ids
    number that order ``0..n-1``.
    """
    pend: list = []
    for k, tn in enumerate(spec.tenants):
        rng = np.random.default_rng(np.random.SeedSequence([spec.seed, k]))
        if tn.process == "trace":
            times = [float(t) for t in tn.trace_times_s
                     if float(t) < spec.horizon_s]
        else:
            times = _poisson_times(rng, tn.rate_hz, 0.0, spec.horizon_s)
            if tn.process == "burst" and tn.burst_factor > 1.0:
                extra = _poisson_times(
                    rng, tn.rate_hz * (tn.burst_factor - 1.0),
                    tn.burst_start_s, min(tn.burst_end_s, spec.horizon_s))
                times = sorted(times + extra)
        lo, hi = tn.blocks_per_job
        tlo, thi = tn.block_time_s
        for t in times:
            nb = int(rng.integers(lo, hi + 1))
            bt = tuple(float(x) for x in rng.uniform(tlo, thi, size=nb))
            pend.append(JobArrival(
                job_id=-1, tenant=tn.name, priority=tn.priority,
                time=float(t), deadline_s=float(t) + tn.slo_s,
                block_times=bt, records_per_block=tn.records_per_block))
    pend.sort(key=lambda j: (j.time, -j.priority, j.tenant))
    return tuple(dataclasses.replace(j, job_id=i)
                 for i, j in enumerate(pend))
