"""Node failure model + seeded chaos campaigns with conservation checks.

``SlowdownEvent``/``FaultEvent`` only re-price work; a ``NodeFailureEvent``
*loses* it.  Two flavors:

  transient    an outage window: the node goes down at ``time`` and comes
               back ``repair_s`` (the MTTR) later.  Its in-flight block is
               killed, its queued blocks freeze until repair — unless the
               recovery policy (``repro_torch.runtime.recovery``) decides the
               deadline cannot wait and evacuates them to survivors.
  permanent    the node never returns.  Without recovery its queued blocks
               are stranded and reported missed; with recovery they are
               re-planned onto survivors at crash time.

In-flight work on a crashed node is lost back to record granularity: the
block restarts from scratch wherever it lands next.  A
``CheckpointModel(interval_s)`` softens that — completed work up to the
last checkpoint tick (wall-clock ticks from the block's launch) survives,
and only the un-checkpointed remainder re-runs (the engine scales the
block's remaining work; see ``recovery.salvage_fraction``).

Both crash flavors land in the engine's total event order (``NODE_DOWN`` /
``NODE_UP`` kinds, ``repro_torch.runtime.events``): a crash at the exact
timestamp of a ``FREQ_SWITCH`` kills the pending switch (crash-during-
switch), and a crash while a migration transfer window is open aborts the
wire draw (crash-during-transfer) — the transfer energy already spent is
burned, the blocks still on the wire re-enter recovery planning.

The chaos harness at the bottom is the acceptance machinery: seeded
randomized campaigns (crash/repair schedules × migration × power cap ×
online calibration × checkpoint salvage) asserting conservation
invariants —

  * every planned block either finishes exactly once (event log) or is
    explicitly reported in ``RuntimeReport.missed_blocks``;
  * per-node busy energy reconstructed from the event log equals the
    report's ledger, burned (crash-lost) energy included;
  * two runs of one scenario are identical, and the vector engine matches
    the scalar oracle bitwise (report AND event log).

Copied from ``src/repro/runtime/failures.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["NodeFailureEvent", "CheckpointModel", "chaos_scenario",
           "check_conservation", "run_campaign"]


@dataclasses.dataclass(frozen=True)
class NodeFailureEvent:
    """One node outage.  ``repair_s`` is the MTTR: required (positive) for
    ``transient``, forbidden for ``permanent``."""

    time: float
    node: str
    flavor: str = "transient"       # "transient" | "permanent"
    repair_s: float | None = None   # MTTR (transient only)

    def __post_init__(self):
        if self.time < 0:
            raise ValueError("failure time must be >= 0")
        if self.flavor not in ("transient", "permanent"):
            raise ValueError(f"unknown failure flavor {self.flavor!r} "
                             "(pick 'transient' or 'permanent')")
        if self.flavor == "transient":
            if self.repair_s is None or self.repair_s <= 0:
                raise ValueError("a transient outage needs repair_s > 0 "
                                 "(its MTTR)")
        elif self.repair_s is not None:
            raise ValueError("a permanent crash has no repair_s")

    @property
    def repair_at(self) -> float | None:
        return self.time + self.repair_s if self.repair_s is not None \
            else None


@dataclasses.dataclass(frozen=True)
class CheckpointModel:
    """Checkpoint-interval salvage: work completed by the last wall-clock
    checkpoint tick (``launch + k * interval_s``) survives a crash; only
    the un-checkpointed remainder re-runs."""

    interval_s: float

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError("checkpoint interval must be positive")


# --- chaos campaign harness --------------------------------------------------

@dataclasses.dataclass
class ChaosScenario:
    """One seeded scenario: plan + truth + events + a config factory.

    ``config()`` builds a FRESH RuntimeConfig per call — trace/calibrator
    sinks are stateful, so reusing one config across the determinism and
    scalar-vs-vector runs would mix their state.
    """

    seed: int
    plan: object
    truth: list
    blocks: list
    events: list
    _cfg_kwargs: dict

    def config(self):
        from repro_torch.calibrate import OnlineCalibrator
        from repro_torch.runtime.engine import RuntimeConfig
        kw = dict(self._cfg_kwargs)
        if kw.pop("_calibrator", False):
            kw["calibrator"] = OnlineCalibrator(window=24, min_samples=12)
        return RuntimeConfig(**kw)


def chaos_scenario(seed: int) -> ChaosScenario:
    """Random small cluster + crash/repair schedule, fully seeded.

    Sized for campaign throughput (a few nodes, tens of blocks) while still
    drawing from the whole feature matrix: transient and permanent crashes,
    MTTRs short and long (repair after the deadline included), migration
    wire costs, power caps, actuation latency, checkpoint salvage,
    recovery on/off, and occasional online calibration.
    """
    from repro_torch.cluster.node import NodeSpec
    from repro_torch.cluster.planner import plan_cluster
    from repro_torch.core.energy import FrequencyLadder, PowerModel
    from repro_torch.core.scheduler import BlockInfo
    from repro_torch.runtime.actuator import ActuationModel
    from repro_torch.runtime.events import FaultEvent
    from repro_torch.runtime.migrate import MigrationModel
    from repro_torch.runtime.recovery import RecoveryPolicy

    rng = np.random.default_rng(seed)
    n = int(rng.integers(24, 72))
    blocks = [
        BlockInfo(index=i,
                  est_time_fmax=float(rng.uniform(0.2, 2.5)),
                  est_rel_halfwidth=float(rng.uniform(0, 0.2)),
                  util=float(rng.uniform(0.4, 1.0)),
                  records=float(rng.integers(50, 2000)))
        for i in range(n)]
    k = int(rng.integers(2, 5))
    ladder = FrequencyLadder((0.5, 0.7, 0.85, 1.0))
    nodes = [NodeSpec(f"n{j}", ladder=ladder,
                      power=PowerModel(p_idle=30 + 2 * j, p_full=110 + 8 * j,
                                       alpha=float(rng.uniform(1.6, 2.8))),
                      speed=float(rng.uniform(0.8, 1.3)))
             for j in range(k)]
    slack = float(rng.uniform(1.2, 2.6))
    deadline = sum(b.est_time_fmax for b in blocks) / k * slack
    plan = plan_cluster(blocks, nodes, deadline_s=deadline)
    truth = [dataclasses.replace(
        b, est_time_fmax=b.est_time_fmax * float(rng.uniform(0.8, 1.4)))
        for b in blocks]

    events: list = []
    for _ in range(int(rng.integers(1, 3))):
        node = f"n{int(rng.integers(0, k))}"
        t = float(rng.uniform(0.15, 0.7)) * deadline
        if rng.random() < 0.35:
            events.append(NodeFailureEvent(time=t, node=node,
                                           flavor="permanent"))
        else:
            mttr = float(rng.uniform(0.05, 0.5)) * deadline
            events.append(NodeFailureEvent(time=t, node=node,
                                           flavor="transient",
                                           repair_s=mttr))
    for _ in range(int(rng.integers(0, 3))):
        events.append(FaultEvent(time=float(rng.uniform(0.1, 0.9)) * deadline,
                                 node=f"n{int(rng.integers(0, k))}",
                                 factor=float(rng.uniform(1.05, 1.8))))

    idle_floor = sum(nd.power.p_idle for nd in nodes)
    cap = None
    if rng.random() < 0.4:
        cap = idle_floor + float(rng.uniform(0.5, 1.5)) * \
            sum(nd.power.p_full - nd.power.p_idle for nd in nodes) / k
    online = bool(rng.random() < 0.85)
    migrate = online and bool(rng.random() < 0.7)
    recovery = None
    if online and rng.random() < 0.8:
        checkpoint = CheckpointModel(
            interval_s=float(rng.uniform(0.05, 0.3)) * deadline) \
            if rng.random() < 0.5 else None
        recovery = RecoveryPolicy(checkpoint=checkpoint,
                                  margin=float(rng.choice([0.0, 0.05])),
                                  max_waits=int(rng.integers(0, 2)))
    cfg_kwargs = dict(
        online=online, migrate=migrate, recovery=recovery,
        actuation=ActuationModel(
            latency_s=float(rng.choice([0.0, 0.0, 0.2])),
            switch_energy_j=float(rng.choice([0.0, 0.2]))),
        migration=MigrationModel(
            latency_s_per_block=float(rng.choice([0.0, 0.5, 2.0])),
            energy_j_per_record=float(rng.choice([0.0, 0.002, 0.01]))),
        power_cap_w=cap, log_events=True,
        _calibrator=bool(online and rng.random() < 0.15))
    return ChaosScenario(seed=seed, plan=plan, truth=truth, blocks=blocks,
                         events=events, _cfg_kwargs=cfg_kwargs)


def _planned_indices(plan) -> list:
    cpa = plan.to_arrays() if hasattr(plan, "to_arrays") else plan
    out: list = []
    for npa in cpa.node_plans:
        out.extend(int(i) for i in npa.plan.index.tolist())
    return out


def check_conservation(report, plan, *, rel_tol: float = 1e-9,
                       planned_extra=()) -> list:
    """Audit one run's report against its own event log; returns violation
    strings (empty == every invariant held).  Needs ``log_events=True``.

    ``planned_extra`` extends the planned set with block indices admitted
    past the plan (open-loop serving: accepted-and-not-shed arrivals) —
    they obey the same exactly-once contract, and a shed or rejected
    arrival that still finishes is flagged as a stray.

    Invariants:
      * exactly-once-or-reported-lost — every planned block index either
        appears exactly once as a ``block_finish`` or is listed in
        ``report.missed_blocks``; never both, never neither, no duplicate
        finishes;
      * ledger/event-log energy agreement — per node, the sequential sum of
        logged finish energies equals the report's busy energy, logged
        crash-burn equals the report's failed energy, and the report totals
        are the node sums;
      * migration energy agreement — the migration ledger equals the sum
        over applied moves;
      * deadline consistency — ``deadline_met`` implies all blocks finished
        and the makespan fits.
    """
    errs: list = []
    planned = _planned_indices(plan)
    planned.extend(int(i) for i in planned_extra)
    finish_count: dict = {}
    finish_energy: dict = {}
    burned: dict = {}
    for row in report.event_log:
        kind, node = row[1], row[2]
        if kind == "block_finish":
            idx = int(row[3])
            finish_count[idx] = finish_count.get(idx, 0) + 1
            finish_energy.setdefault(node, []).append(float(row[5]))
        elif kind == "node_down" and len(row) >= 9 \
                and row[3] in ("transient", "permanent"):
            # data: (flavor, killed_index, burned_busy, burned_energy,
            #        salvaged_frac, wire_aborted_w)
            burned[node] = burned.get(node, 0.0) + float(row[6])

    missed = set(int(i) for i in report.missed_blocks)
    dup = sorted(i for i, c in finish_count.items() if c != 1)
    if dup:
        errs.append(f"blocks finished more than once: {dup[:8]}")
    for i in planned:
        if i in finish_count and i in missed:
            errs.append(f"block {i} both finished and reported missed")
        elif i not in finish_count and i not in missed:
            errs.append(f"block {i} neither finished nor reported missed")
    stray = sorted(set(finish_count) - set(planned))
    if stray:
        errs.append(f"finishes for unplanned blocks: {stray[:8]}")

    def _close(a: float, b: float, what: str) -> None:
        if abs(a - b) > rel_tol * max(abs(a), abs(b), 1.0):
            errs.append(f"{what}: log {a!r} != report {b!r}")

    for nr in report.node_reports:
        seq = 0.0
        for e in finish_energy.get(nr.name, ()):
            seq += e
        _close(seq, nr.energy_j, f"busy energy on {nr.name}")
        _close(burned.get(nr.name, 0.0), nr.failed_energy_j,
               f"burned (crash-lost) energy on {nr.name}")
    _close(sum(nr.energy_j for nr in report.node_reports),
           report.total_energy_j, "total busy energy")
    _close(sum(nr.failed_energy_j for nr in report.node_reports),
           report.failed_energy_j, "total burned energy")
    _close(sum(mv.energy_j for mv in report.migrations),
           report.migration_energy_j, "migration wire energy")

    if report.deadline_met:
        if missed:
            errs.append("deadline_met but blocks reported missed")
        if report.makespan_s > report.deadline_s + 1e-9:
            errs.append("deadline_met but makespan exceeds the deadline")
    return errs


def run_campaign(n_scenarios: int = 200, base_seed: int = 0, *,
                 check_vector: bool = True) -> dict:
    """Run ``n_scenarios`` seeded chaos scenarios; returns a summary dict.

    Per scenario: scalar run, second scalar run (two-run determinism),
    vector run (scalar-vs-vector bit-identity, report and event log), and
    ``check_conservation`` on the scalar report.  ``violations`` collects
    every failed invariant as a string — the campaign NEVER raises, so one
    bad seed reports instead of hiding the rest.
    """
    from repro_torch.runtime.engine import run_cluster

    violations: list = []
    n_crashes = n_repairs = n_met = n_missed_runs = n_recovery = 0
    for s in range(n_scenarios):
        sc = chaos_scenario(base_seed + s)

        def _one(engine):
            return run_cluster(sc.plan, sc.truth, config=sc.config(),
                               events=sc.events, est_blocks=sc.blocks,
                               engine=engine)

        a = _one("scalar")
        b = _one("scalar")
        if a != b or a.event_log != b.event_log:
            violations.append(f"seed {sc.seed}: two scalar runs differ")
        if check_vector:
            v = _one("vector")
            if a != v:
                violations.append(f"seed {sc.seed}: scalar != vector report")
            elif a.event_log != v.event_log:
                violations.append(f"seed {sc.seed}: scalar != vector "
                                  f"event log")
        for err in check_conservation(a, sc.plan):
            violations.append(f"seed {sc.seed}: {err}")
        n_crashes += a.n_crashes
        n_repairs += a.n_repairs
        n_met += int(a.deadline_met)
        n_missed_runs += int(bool(a.missed_blocks))
        n_recovery += len(a.recoveries)
    return {"n_scenarios": n_scenarios, "violations": violations,
            "n_crashes": n_crashes, "n_repairs": n_repairs,
            "deadline_met_runs": n_met, "runs_with_missed": n_missed_runs,
            "recovery_decisions": n_recovery}
