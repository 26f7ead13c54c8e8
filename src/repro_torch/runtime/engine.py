"""Deterministic discrete-event cluster runtime.

Subsumes the block-boundary loop of ``repro_torch.cluster.sim``: one event clock
drives every node, so mid-block frequency switches (async actuation),
time-based faults, cross-node migration, and a cluster-wide power cap all
compose — none of them needs to wait for a block to finish.

Contracts (``tests/test_runtime.py``):

  compat      with no faults, no cap, and actuation latency 0 the engine
              reproduces the block-boundary reference loop
              (``simulate_cluster_reference``) bit-for-bit: per-node busy
              seconds, energies, frequencies, and finish times are the
              exact same float chains.
  segments    a block split across k frequencies costs exactly
              ``sum_j w_j * T(f_j)`` seconds and
              ``sum_j w_j * T(f_j) * P(util, f_j)`` joules — the
              ``block_time_table`` / ``busy_energy_table`` maths applied
              per segment (see ``repro_torch.runtime.actuator``).
  migration   only queued blocks move, and only onto nodes that stay
              predicted-feasible (see ``repro_torch.runtime.migrate``).
  power cap   the instantaneous cluster draw (busy nodes at ``P(util, f)``,
              idle nodes at ``p_idle``) never exceeds ``power_cap_w``: block
              launches are clamped to the highest fitting ladder state or
              deferred entirely, and clock-ups are staggered until a finish
              or down-switch releases headroom.
  determinism the event queue is totally ordered (time, kind, node, seq),
              every policy breaks ties by node/block id, and the engine
              holds no RNG — two runs of one scenario produce identical
              event logs.

The engine consumes ``ClusterPlanArrays`` directly (the streamed pipeline's
plans feed straight in; a ``ClusterPlan`` is normalized on entry).  In
static mode no per-block Python object is ever materialized; online mode
builds the ``OnlineReplanner``'s estimate objects once at startup.

Copied from ``src/repro/runtime/engine.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.calibrate.trace import CounterSample
from repro_torch.cluster.controller import OnlineReplanner
from repro_torch.cluster.planner import ClusterPlan, ClusterPlanArrays
from repro_torch.core.soa import BlockArrays
from repro_torch.runtime.actuator import ActuationModel, InFlight, PowerLedger
from repro_torch.runtime.events import (BLOCK_FINISH, BLOCK_START, FAULT,
                                  FREQ_SWITCH, JOB_ARRIVAL, KIND_NAMES,
                                  NODE_DOWN, NODE_UP, TELEMETRY,
                                  WIRE_RELEASE, Event, EventLogSink,
                                  EventQueue, FaultEvent)
from repro_torch.runtime.failures import NodeFailureEvent
from repro_torch.runtime.migrate import MigrationModel, plan_moves
from repro_torch.runtime.recovery import recover_crash, salvage_fraction

__all__ = ["RuntimeConfig", "NodeRuntimeReport", "RuntimeReport",
           "ClusterRuntime", "run_cluster"]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Everything the event-driven run needs beyond the plan itself."""

    online: bool = False               # feedback re-planning (OnlineReplanner)
    migrate: bool = False              # cross-node migration (implies online)
    actuation: ActuationModel = ActuationModel()
    migration: MigrationModel = MigrationModel()  # per-move transfer cost
    power_cap_w: float | None = None   # cluster-wide instantaneous cap
    max_moves: int | None = None       # migration moves per trigger (None=all)
    replan_threshold: float = 0.15     # controller knobs (as simulate_cluster)
    ewma_alpha: float = 0.3
    error_margin: float = 0.05
    log_events: bool = True
    # event-log retention: "full" keeps every row (the default, unchanged),
    # "ring:N" is the flight recorder (last N rows, dropped count reported),
    # "off" keeps none.  Only "full" logs are replayable — the serving
    # fabric and the failure audits read the whole log.  Ignored entirely
    # when log_events=False.
    event_log: str = "full"
    # inline streaming-metrics sink (repro_torch.obs.StreamingMetrics): fed
    # from the handlers + the power ledger while the run executes, without
    # materializing the event log.  STATEFUL, like trace/calibrator below:
    # construct a fresh one per run.
    metrics: object | None = None
    # crash recovery (repro_torch.runtime.recovery): how NodeFailureEvents are
    # answered — checkpoint salvage, wait-for-repair vs evacuate ladder.
    # None still HANDLES failures (crash kills work, repair resumes the
    # frozen queue); it just never salvages or evacuates.
    recovery: object | None = None     # recovery.RecoveryPolicy
    # STATEFUL sinks, unlike every other field: the recorder accumulates
    # samples and the calibrator keeps warm fit windows across calls.
    # Reusing one config object across runs therefore mixes their state
    # (trace() spans both runs; the second run starts pre-calibrated) —
    # intentional for continual calibration, but for a clean per-run trace
    # or two-run-identical event logs, construct fresh ones per run.
    trace: object | None = None        # calibrate.TraceRecorder sink
    calibrator: object | None = None   # calibrate.OnlineCalibrator

    def __post_init__(self):
        if self.migrate and not self.online:
            raise ValueError("migration needs the online controller "
                             "(RuntimeConfig(online=True, migrate=True))")
        if self.calibrator is not None and not self.online:
            raise ValueError("online calibration needs the online "
                             "controller (RuntimeConfig(online=True, "
                             "calibrator=...))")
        if self.power_cap_w is not None and self.power_cap_w <= 0:
            raise ValueError("power_cap_w must be positive")
        if self.recovery is not None and not self.online:
            raise ValueError("crash recovery needs the online controller "
                             "(RuntimeConfig(online=True, recovery=...))")
        self.ring_capacity()   # validates the event_log mode string

    def ring_capacity(self) -> int | None:
        """Ring size for ``event_log="ring:N"``; None for full/off."""
        mode = self.event_log
        if mode in ("full", "off"):
            return None
        if mode.startswith("ring:"):
            try:
                n = int(mode[5:])
            except ValueError:
                n = 0
            if n > 0:
                return n
        raise ValueError(f"unknown event_log mode {mode!r} "
                         "(pick 'full', 'ring:N', or 'off')")


@dataclasses.dataclass(frozen=True)
class NodeRuntimeReport:
    """Per-node outcome; the first five fields mirror ``sim.NodeReport``."""

    name: str
    busy_s: float
    energy_j: float          # busy-only (paper formula 7), segments summed
    n_blocks: int
    freqs: tuple             # per finished block: the frequency it ENDED at
    finish_s: float          # event time of the last block finish
    n_switches: int          # applied mid-run transitions
    switch_energy_j: float
    migrated_in: int
    migrated_out: int
    migrate_energy_j: float = 0.0  # transfer joules charged as the SOURCE
    crashes: int = 0               # NODE_DOWN events that landed here
    repairs: int = 0               # NODE_UP events that landed here
    down_s: float = 0.0            # repaired outage seconds
    failed_busy_s: float = 0.0     # busy seconds burned by crashes
    failed_energy_j: float = 0.0   # joules burned by crashes (lost work)
    salvaged_frac: float = 0.0     # checkpoint-saved work fractions, summed


@dataclasses.dataclass(frozen=True)
class RuntimeReport:
    planner: str
    deadline_s: float
    makespan_s: float        # max node finish TIME (gaps included)
    total_energy_j: float    # busy-only, summed over nodes
    idle_energy_j: float     # non-busy tail of every node up to the deadline
    deadline_met: bool
    node_reports: tuple      # of NodeRuntimeReport
    n_replans: int = 0
    n_migrations: int = 0
    n_switches: int = 0
    switch_energy_j: float = 0.0
    migration_energy_j: float = 0.0  # wire transfer joules, summed over moves
    peak_power_w: float = 0.0
    power_cap_w: float | None = None
    migrations: tuple = ()   # of migrate.MigrationRecord
    event_log: tuple = ()    # (time, kind_name, node_name, *data) tuples
    n_crashes: int = 0
    n_repairs: int = 0
    failed_busy_s: float = 0.0       # crash-burned busy seconds, all nodes
    failed_energy_j: float = 0.0     # crash-burned joules, all nodes
    missed_blocks: tuple = ()        # planned indices that never finished
    lost_records: float = 0.0        # records inside the missed blocks
    recoveries: tuple = ()           # of recovery.RecoveryDecision
    # (time, total_w) cluster-draw steps, recorded when the full event log
    # is on — the piecewise-constant power track the exporters draw
    power_samples: tuple = ()
    events_dropped: int = 0          # ring-evicted rows (0 for full/off)
    # how the event log was captured: "full", "ring:N", or "off" — the
    # flight-recorder guard (spans/attribution refuse truncated logs)
    event_log_mode: str = "full"

    def improvement_vs(self, other) -> float:
        """Fractional busy-energy improvement of self over ``other``."""
        if other.total_energy_j <= 0:
            return 0.0
        return 1.0 - self.total_energy_j / other.total_energy_j


class _NodeState:
    """Mutable per-node runtime state (one per plan node)."""

    __slots__ = ("spec", "true_spec", "nid", "idx", "freq", "ptr", "done",
                 "busy_s", "energy_j", "freqs", "inflight", "hw_freq",
                 "fault_factor", "slow_events", "pending_target", "want_up",
                 "waiting", "finish_s", "n_switches", "switch_energy_j",
                 "migrated_in", "migrated_out", "migrate_stuck",
                 "migrate_energy_j", "up", "down_since", "down_s", "crashes",
                 "repairs", "failed_busy_s", "failed_energy_j",
                 "salvaged_frac", "recovery_waits", "wire_open_w",
                 "wire_open_n", "wire_stale", "gen_base")

    def __init__(self, spec, nid: int, idx: np.ndarray, freq: np.ndarray):
        self.spec = spec
        self.true_spec = spec     # hardware truth (overridden by true_nodes)
        self.nid = nid
        self.idx = idx            # static queue: global block indices
        self.freq = freq          # static queue: planned frequencies
        self.ptr = 0              # static queue head
        self.done = 0
        self.busy_s = 0.0
        self.energy_j = 0.0
        self.freqs: list = []
        self.inflight: InFlight | None = None
        self.hw_freq: float | None = None   # set at first launch
        self.fault_factor = 1.0             # product of time-based faults
        self.slow_events: list = []         # sorted (after_block, factor)
        self.pending_target: float | None = None  # in-latency switch target
        self.want_up: float | None = None   # cap-deferred clock-up target
        self.waiting = False                # cap-deferred block launch
        self.finish_s = 0.0
        self.n_switches = 0
        self.switch_energy_j = 0.0
        self.migrated_in = 0
        self.migrated_out = 0
        self.migrate_stuck = False  # last migration attempt left a miss
        self.migrate_energy_j = 0.0  # transfer joules charged as the source
        self.up = True              # node availability (NODE_DOWN/NODE_UP)
        self.down_since = 0.0       # crash timestamp while down
        self.down_s = 0.0           # repaired outage seconds
        self.crashes = 0
        self.repairs = 0
        self.failed_busy_s = 0.0    # busy seconds burned by crashes
        self.failed_energy_j = 0.0  # joules burned by crashes
        self.salvaged_frac = 0.0    # checkpoint-saved fractions, summed
        self.recovery_waits = 0     # wait-for-repair rungs already taken
        self.wire_open_w = 0.0      # open migration-transfer wire watts
        self.wire_open_n = 0        # open transfer windows on this node
        self.wire_stale = 0         # WIRE_RELEASEs voided by a crash
        # generation floor for fresh launches: a crash-killed block may
        # RELAUNCH (same index) while its pre-crash BLOCK_FINISH is still
        # in the heap — launching past the killed generation keeps that
        # stale event stale (0 == the pre-failure default, bit-compatible)
        self.gen_base = 0


class ClusterRuntime:
    """One simulation run: build, then ``run()`` exactly once."""

    def __init__(
        self,
        plan: ClusterPlanArrays | ClusterPlan,
        truth: BlockArrays,
        *,
        config: RuntimeConfig = RuntimeConfig(),
        events=(),
        est_blocks=None,
        true_nodes=None,
    ):
        plan_obj = plan if isinstance(plan, ClusterPlan) else None
        cpa = plan.to_arrays() if isinstance(plan, ClusterPlan) else plan
        if not isinstance(truth, BlockArrays):
            truth = BlockArrays.from_blocks(truth)
        self.plan = cpa
        self.config = config
        self.deadline_s = cpa.deadline_s

        # truth lookup: global block index -> position in the truth arrays
        self._t_index = truth.index
        self._t_order = np.argsort(truth.index, kind="stable")
        self._t_sorted = truth.index[self._t_order]
        self._t_est = truth.est_time_fmax
        self._t_util = truth.util
        self._t_roof = truth.roofline
        self._t_rec = truth.records
        # blocks admitted past the plan (open-loop serving): counted toward
        # run completeness; 0 on every closed-batch path
        self._extra_planned = 0

        self.nodes: list = []
        self._id_of: dict = {}
        for k, npa in enumerate(cpa.node_plans):
            st = _NodeState(npa.node, k, npa.plan.index, npa.plan.rel_freq)
            self.nodes.append(st)
            self._id_of[npa.node.name] = k

        # hardware truth per node: the plan's specs are the planner's BELIEF
        # (what frequencies were chosen against); ``true_nodes`` is what the
        # machines actually are — time prices off the true speed, energy and
        # the power ledger off the true power model.  Default: belief ==
        # truth, which keeps the engine bit-for-bit on the compat path.
        if true_nodes is not None:
            by_name = {nd.name: nd for nd in true_nodes} \
                if not isinstance(true_nodes, dict) else dict(true_nodes)
            for st in self.nodes:
                st.true_spec = by_name.get(st.spec.name, st.spec)

        # planner-unit work lookup for trace emission: the estimates the
        # plan was built from (fitted speeds are then EFFECTIVE speeds
        # w.r.t. those estimates — see repro_torch.calibrate.trace)
        self._work_est = ({b.index: b.est_time_fmax for b in est_blocks}
                          if est_blocks is not None else None)
        self._emit_trace = config.trace is not None \
            or config.calibrator is not None
        self._mig_ready: dict = {}   # block index -> earliest start on dst

        for ev in events:
            if isinstance(ev, (FaultEvent, NodeFailureEvent)):
                continue  # queued at run() start
            # block-boundary slowdown: sort per node by (after_block, factor)
            # — the total order that makes same-trigger events input-order
            # independent (the old loop applied them in input order)
            self.nodes[self._id_of[ev.node]].slow_events.append(
                (ev.after_block, ev.factor))
        for st in self.nodes:
            st.slow_events.sort()
        self._fault_events = tuple(ev for ev in events
                                   if isinstance(ev, FaultEvent))
        self._failure_events = tuple(ev for ev in events
                                     if isinstance(ev, NodeFailureEvent))
        self._has_failures = bool(self._failure_events)
        # per-block remaining-work scale: checkpoint salvage shrinks a
        # killed block's re-run to its un-checkpointed remainder.  Empty
        # unless a crash actually salvages — every pricing path multiplies
        # only when non-empty, keeping zero-failure runs bitwise untouched.
        self._work_scale: dict = {}
        # finished global indices, kept only when failures can lose blocks
        # (set membership answers "which planned blocks never ran?")
        self._done_idx: list = []
        self.recoveries: list = []

        self.controller = None
        if config.online:
            # seed SoA-native: the controller consumes ClusterPlanArrays
            # directly, and with no explicit est_blocks the truth arrays ARE
            # the base estimates (same floats, zero conversion) — a
            # million-block run no longer materializes BlockInfo objects
            rp = config.recovery
            self.controller = OnlineReplanner(
                plan_obj if plan_obj is not None else cpa, est_blocks,
                base_arrays=truth if est_blocks is None else None,
                replan_threshold=config.replan_threshold,
                ewma_alpha=config.ewma_alpha,
                error_margin=config.error_margin,
                calibrator=config.calibrator,
                track_ratios=bool(rp is not None
                                  and getattr(rp, "use_triage", False)))
            self.controller.attach_work_scale(self._work_scale)

        idle = [st.true_spec.power.p_idle for st in self.nodes]
        if config.power_cap_w is not None \
                and sum(idle) > config.power_cap_w + 1e-9:
            raise ValueError(
                f"power cap {config.power_cap_w} W is below the cluster's "
                f"idle floor {sum(idle)} W — nothing can run")
        # event-log retention: full mode stays a plain list (zero hot-path
        # indirection), ring mode is the flight recorder, off logs nothing.
        ring_n = config.ring_capacity()
        self._log_on = config.log_events and config.event_log != "off"
        # power samples are only recorded for replayable (full) logs — the
        # ring/off modes exist to bound memory, and the streaming metrics
        # sink carries the bounded power timeline instead
        record = config.log_events and config.event_log == "full"
        self._mx = config.metrics
        if self._mx is not None:
            self._mx.bind(self)
        self.ledger = PowerLedger(
            idle, config.power_cap_w, record=record,
            observer=(self._mx.on_power if self._mx is not None else None))
        self.queue = EventQueue()
        self.log = EventLogSink(ring_n) if (self._log_on
                                            and ring_n is not None) else []
        self.migrations: list = []
        self._pending_tel = 0    # TELEMETRY events pushed but not handled
        self._pending_wire = 0   # WIRE_RELEASE events pushed but not handled
        self._off_plan = 0       # cap-clamped launches (off-plan durations)
        self._ran = False

    # --- truth costs (bitwise-identical to the scalar block_time path) ------
    def _truth_pos(self, index: int) -> int:
        j = int(np.searchsorted(self._t_sorted, index))
        if j >= len(self._t_sorted) or self._t_sorted[j] != index:
            raise KeyError(f"no true block with index {index}")
        return int(self._t_order[j])

    def _true_time(self, pos: int, node: _NodeState, rel_freq: float) -> float:
        """``NodeSpec.block_time`` on the truth arrays, op-for-op.

        Priced off the node's TRUE spec: with ``true_nodes`` the plan's
        frequencies were chosen against a belief, but the hardware runs at
        its actual speed — the gap is exactly what calibration closes.
        """
        est = float(self._t_est[pos])
        if self._t_roof is not None and bool(self._t_roof.has[pos]):
            t_comp = float(self._t_roof.t_comp[pos])
            t_mem = float(self._t_roof.t_mem[pos])
            t_coll = float(self._t_roof.t_coll[pos])
            t_fixed = float(self._t_roof.t_fixed[pos])
            f = max(rel_freq, 1e-6)
            at_f = max(t_comp / f, t_mem, t_coll) + t_fixed
            at_1 = max(t_comp / 1.0, t_mem, t_coll) + t_fixed
            base = at_f * (est / max(at_1, 1e-12))
        else:
            base = est / max(rel_freq, 1e-6)
        return base / node.true_spec.speed

    def _scaled_true_time(self, pos: int, index: int, node: _NodeState,
                          rel_freq: float) -> float:
        """``_true_time`` with the crash-salvage work scale folded in: a
        checkpoint-salvaged block re-runs only its remainder.  With no
        salvage on record the result is the unscaled float, bitwise."""
        t = self._true_time(pos, node, rel_freq)
        if self._work_scale:
            s = self._work_scale.get(index)
            if s is not None:
                t = t * s
        return t

    def _scale_of(self, idx) -> np.ndarray:
        """Per-element work scale for an index array (vectorized pricing);
        1.0 where no crash ever salvaged the block."""
        ws = self._work_scale
        return np.fromiter((ws.get(int(i), 1.0) for i in idx.tolist()),
                           np.float64, count=len(idx))

    def _extend_truth(self, extra: BlockArrays) -> None:
        """Append arrived blocks to the hardware-truth lookup (open-loop
        serving only; closed-batch runs never call this).

        Pre-existing lookups keep their exact floats: the payload arrays
        are ``np.concatenate`` copies and positions re-derive from a stable
        argsort of the concatenated index array.
        """
        old_n = len(self._t_index)
        n_new = len(extra)
        index = np.concatenate([self._t_index, extra.index])
        self._t_index = index
        self._t_order = np.argsort(index, kind="stable")
        self._t_sorted = index[self._t_order]
        self._t_est = np.concatenate([self._t_est, extra.est_time_fmax])
        self._t_util = np.concatenate([self._t_util, extra.util])
        a_roof, b_roof = self._t_roof, extra.roofline
        if a_roof is not None or b_roof is not None:
            def _part(r, n):
                if r is not None:
                    return (r.has, r.t_comp, r.t_mem, r.t_coll, r.t_fixed)
                z = np.zeros(n)
                return (np.zeros(n, dtype=bool), z, z, z, z)
            pa, pb = _part(a_roof, old_n), _part(b_roof, n_new)
            from repro_torch.core.soa import RooflineArrays
            self._t_roof = RooflineArrays(
                *(np.concatenate([x, y]) for x, y in zip(pa, pb)))
        if self._t_rec is not None or extra.records is not None:
            a = self._t_rec if self._t_rec is not None else np.zeros(old_n)
            b = extra.records if extra.records is not None \
                else np.zeros(n_new)
            self._t_rec = np.concatenate([a, b])
        self._on_truth_extended()

    def _on_truth_extended(self) -> None:
        """Hook for subclasses caching views of the truth/base arrays."""

    def _job_arrival(self, now: float, st: _NodeState, data: tuple) -> None:
        """JOB_ARRIVAL dispatch; a serving fabric must be attached
        (``repro_torch.serving``) — the closed-batch engine never schedules one."""
        raise RuntimeError("JOB_ARRIVAL event without a serving fabric — "
                           "use repro_torch.serving.run_serving for open-loop "
                           "arrival streams")

    # --- event handlers ------------------------------------------------------
    def _log(self, time: float, kind: int, node: _NodeState, *data) -> None:
        if self._log_on:
            self.log.append((time, KIND_NAMES[kind], node.spec.name) + data)

    def _next_planned(self, st: _NodeState):
        """(global index, planned freq) of the node's next block, or None."""
        if self.controller is not None:
            return self.controller.next_block_brief(st.spec.name)
        if st.ptr >= len(st.idx):
            return None
        return int(st.idx[st.ptr]), float(st.freq[st.ptr])

    def _count_factor(self, st: _NodeState) -> float:
        factor = 1.0
        for after_block, fac in st.slow_events:
            if st.done >= after_block:
                factor *= fac
        return factor

    def _highest_fitting(self, st: _NodeState, util: float,
                         ceiling: float) -> float | None:
        """Highest ladder state <= ceiling whose draw fits under the cap."""
        for f in reversed(st.spec.ladder.states):
            if f > ceiling + 1e-12:
                continue
            if self.ledger.fits(st.nid, st.true_spec.power.power(util, f)):
                return f
        return None

    def _charge_switch(self, st: _NodeState) -> None:
        st.n_switches += 1
        st.switch_energy_j += self.config.actuation.switch_energy_j

    def _start_block(self, now: float, st: _NodeState) -> None:
        if st.inflight is not None:
            return  # stale start (e.g. a power-release retry while busy)
        if not st.up:
            return  # node is down; NODE_UP re-seeds the launch
        nxt = self._next_planned(st)
        if nxt is None:
            return
        index, planned = nxt
        if self._mig_ready:
            # a migrated head block is still on the wire: sleep until the
            # transfer completes (duplicate wakeups are harmless — the
            # first launch wins, later ones see the node busy)
            ready = self._mig_ready.get(index)
            if ready is not None:
                if ready > now + 1e-12:
                    self.queue.push(Event(ready, BLOCK_START, st.nid))
                    return
                # the transfer completed and the block is launching: its
                # wire entry can never gate anything again (only the queue
                # head launches, and it leaves the queue right here)
                del self._mig_ready[index]
        pos = self._truth_pos(index)
        util = float(self._t_util[pos])
        latency = self.config.actuation.latency_s

        # launch frequency: instant actuation runs the plan directly; with
        # latency the hardware is still at its previous frequency and the
        # switch toward the plan lands mid-block
        desired = planned
        f_launch = desired if latency == 0.0 or st.hw_freq is None \
            else st.hw_freq

        # cluster power cap: clamp the launch down the ladder, or defer the
        # whole launch until a finish/down-switch frees headroom
        f_run = f_launch
        if self.ledger.cap_w is not None:
            f_run = self._highest_fitting(st, util, f_launch)
            if f_run is None:
                st.waiting = True
                self._log(now, BLOCK_START, st, "deferred", index)
                if self._mx is not None:
                    self._mx.on_defer(now, st.nid)
                return
            if f_run != f_launch:
                # cap clamp: the block runs off its planned duration, so any
                # drift-scan continuation derived before this launch is void
                self._off_plan += 1
        st.waiting = False

        if st.hw_freq is not None and f_run != st.hw_freq:
            self._charge_switch(st)     # boundary transition (0 J by default)
        st.hw_freq = f_run

        eff = self._count_factor(st) * st.fault_factor
        t_full = self._scaled_true_time(pos, index, st, f_run) * eff
        fl = InFlight(block_pos=pos, block_index=index, rel_freq=f_run,
                      seg_start=now, seg_time=t_full, freqs=(f_run,),
                      generation=st.gen_base)
        st.inflight = fl
        self.ledger.set_draw(st.nid, st.true_spec.power.power(util, f_run),
                             now)
        self._log(now, BLOCK_START, st, index, f_run)
        if self._mx is not None:
            self._mx.on_launch(now, st.nid, index, f_run)
        self.queue.push(Event(now + t_full, BLOCK_FINISH, st.nid,
                              (index, fl.generation)))

        # off-plan launch: bring the block toward its planned frequency.
        # A cap-clamped launch that wants to go UP must stagger (retry on
        # power release); anything else is an async switch request that
        # lands ``latency`` later (mid-block when latency > 0).
        if abs(f_run - desired) > 1e-12:
            if desired > f_run and f_run < f_launch - 1e-12:
                st.want_up = desired
            else:
                st.pending_target = desired
                self.queue.push(Event(now + latency, FREQ_SWITCH, st.nid,
                                      (desired,)))

    def _finish_block(self, now: float, st: _NodeState, data: tuple) -> None:
        index, generation = data
        fl = st.inflight
        if fl is None or fl.block_index != index \
                or fl.generation != generation:
            return  # stale finish: the remainder was re-priced after this
        util = float(self._t_util[fl.block_pos])
        # the final segment's duration is its scheduled seg_time, not the
        # clock difference — keeps single-segment blocks bitwise identical
        # to the block-boundary loop (busy += t with the same t)
        final_energy = st.true_spec.power.busy_energy(
            fl.seg_time, fl.rel_freq, util=util)
        block_busy = fl.busy_s + fl.seg_time
        block_energy = fl.energy_j + final_energy
        samples = ()
        if self._emit_trace:
            samples = self._emit_samples(st, fl, index, util, final_energy)
        st.busy_s += block_busy
        st.energy_j += block_energy
        st.freqs.append(fl.rel_freq)
        st.done += 1
        st.finish_s = now
        st.inflight = None
        if self._has_failures:
            self._done_idx.append(index)
        st.want_up = None   # a cap-deferred clock-up dies with its block
        if self.controller is None:
            st.ptr += 1
        self.ledger.set_idle(st.nid, now)
        self._log(now, BLOCK_FINISH, st, index, block_busy, block_energy)
        if self._mx is not None:
            self._mx.on_finish(now, st.nid, index, block_busy, block_energy)
        self._power_released(now)
        if self.controller is not None:
            self.queue.push(Event(now, TELEMETRY, st.nid,
                                  (index, block_busy, samples)))
            self._pending_tel += 1
        self.queue.push(Event(now, BLOCK_START, st.nid))

    def _emit_samples(self, st: _NodeState, fl: InFlight, index: int,
                      util: float, final_energy: float) -> tuple:
        """The finished block as counter-trace samples, one per segment
        (``repro_torch.calibrate.trace`` format): closed segments from the
        in-flight log plus the final one.  ``work_done`` is in planner
        units — the estimate the plan was built from — scaled by each
        segment's completed work fraction."""
        work = float(self._work_est[index]) if self._work_est is not None \
            else float(self._t_est[fl.block_pos])
        name = st.spec.name
        segs = fl.seg_log + [(fl.seg_start, fl.seg_time, fl.rel_freq,
                              fl.remaining, final_energy)]
        samples = tuple(
            CounterSample(t=t0, dur_s=dur, node=name, freq=f, util=util,
                          energy_j=e, work_done=frac * work)
            for t0, dur, f, frac, e in segs)
        if self.config.trace is not None:
            self.config.trace.extend(samples)
        return samples

    def _telemetry(self, now: float, st: _NodeState, data: tuple) -> None:
        index, observed_s, samples = data
        self._pending_tel -= 1
        replanned = self.controller.on_telemetry(st.spec.name, observed_s,
                                                 samples=samples)
        self._log(now, TELEMETRY, st, index, observed_s, replanned)
        if not self.config.migrate:
            return
        # the O(queue) miss prediction runs only when something moved: a
        # fresh re-plan, or an infeasible node whose LAST attempt still
        # placed blocks — targets don't gain capacity between re-plans, so
        # an attempt that could not cure the miss stays stuck until the
        # next re-plan re-arms it
        if replanned:
            st.migrate_stuck = False
        if st.migrate_stuck or (not replanned
                                and self.controller.node_feasible(
                                    st.spec.name)):
            return
        margin = self.config.error_margin
        if not self.controller.predicted_miss(st.spec.name, margin=margin):
            return
        moves = plan_moves(self.controller, st.spec.name, now, margin=margin,
                           max_moves=self.config.max_moves,
                           migration=self.config.migration,
                           wire_budget_w=self.ledger.headroom_w())
        st.migrate_stuck = self.controller.predicted_miss(st.spec.name,
                                                          margin=margin)
        wire_w = 0.0
        latency = self.config.migration.latency_s_per_block
        for mv in moves:
            self.migrations.append(mv)
            st.migrated_out += 1
            st.migrate_energy_j += mv.energy_j
            if mv.energy_j > 0 and latency > 0:
                wire_w += mv.energy_j / latency
            dst = self.nodes[self._id_of[mv.dst]]
            dst.migrated_in += 1
            if mv.ready_s > now + 1e-12:
                # transfer latency: the block may not launch before ready_s
                self._mig_ready[mv.block_index] = mv.ready_s
            self._log(now, TELEMETRY, st, "migrate", mv.block_index, mv.dst)
            if self._mx is not None:
                self._mx.on_migrate(now, st.nid, dst.nid, mv.energy_j)
            if dst.inflight is None:
                # a drained (or deferred) target got work: wake it
                self.queue.push(Event(now, BLOCK_START, dst.nid))
        if wire_w > 0:
            # the transfers draw wire power on the SOURCE for the transfer
            # window — the cap (and the peak) see the wire, not just chips.
            # plan_moves already budgeted the watts against headroom_w().
            self.ledger.add_aux(st.nid, wire_w, now)
            self.queue.push(Event(now + latency, WIRE_RELEASE, st.nid,
                                  (wire_w,)))
            self._pending_wire += 1
            st.wire_open_w += wire_w
            st.wire_open_n += 1

    def _freq_switch(self, now: float, st: _NodeState, data: tuple) -> None:
        target = data[0]
        if st.pending_target is None or \
                abs(st.pending_target - target) > 1e-12:
            return  # stale request (superseded or block already finished)
        st.pending_target = None
        fl = st.inflight
        if fl is None:
            # landed between blocks: the hardware settles at the target
            if st.hw_freq != target:
                st.hw_freq = target
                self._charge_switch(st)
                self._log(now, FREQ_SWITCH, st, target, "idle")
            return
        util = float(self._t_util[fl.block_pos])
        new_f = target
        if self.ledger.cap_w is not None:
            new_f = self._highest_fitting(st, util, target)
            if target > fl.rel_freq and \
                    (new_f is None or new_f <= fl.rel_freq + 1e-12):
                st.want_up = target   # stagger: retry on power release
                return
            if new_f is None or abs(new_f - fl.rel_freq) <= 1e-12:
                return                # nothing to change
        old_f = fl.rel_freq
        if new_f < target - 1e-12:
            st.want_up = target   # partial climb: resume on power release
        # a mid-block split re-prices the in-flight remainder: any cached
        # drift-scan continuation is void (same flag as the cap clamp)
        self._off_plan += 1
        fl.split_at(now, st.true_spec.power, util)
        fl.rel_freq = new_f
        fl.freqs = fl.freqs + (new_f,)
        st.hw_freq = new_f
        eff = self._count_factor(st) * st.fault_factor
        fl.seg_time = fl.remaining * (
            self._scaled_true_time(fl.block_pos, fl.block_index, st, new_f)
            * eff)
        fl.generation += 1
        self._charge_switch(st)
        self.ledger.set_draw(st.nid, st.true_spec.power.power(util, new_f),
                             now)
        self._log(now, FREQ_SWITCH, st, fl.block_index, old_f, new_f)
        self.queue.push(Event(now + fl.seg_time, BLOCK_FINISH, st.nid,
                              (fl.block_index, fl.generation)))
        if new_f < old_f:
            self._power_released(now)

    def _fault(self, now: float, st: _NodeState, data: tuple) -> None:
        factor = data[0]
        st.fault_factor *= factor
        self._log(now, FAULT, st, factor)
        fl = st.inflight
        if fl is None:
            return
        util = float(self._t_util[fl.block_pos])
        fl.split_at(now, st.true_spec.power, util)
        eff = self._count_factor(st) * st.fault_factor
        fl.seg_time = fl.remaining * (
            self._scaled_true_time(fl.block_pos, fl.block_index, st,
                                   fl.rel_freq) * eff)
        fl.generation += 1
        self.queue.push(Event(now + fl.seg_time, BLOCK_FINISH, st.nid,
                              (fl.block_index, fl.generation)))

    def _wire_release(self, now: float, st: _NodeState, data: tuple) -> None:
        """A migration transfer window closed: drop its wire watts."""
        wire_w = data[0]
        self._pending_wire -= 1
        if st.wire_stale > 0:
            # the transfer was aborted by a crash: its watts were already
            # released at NODE_DOWN — this release is void
            st.wire_stale -= 1
            self._log(now, WIRE_RELEASE, st, wire_w, "stale")
            return
        st.wire_open_w -= wire_w
        st.wire_open_n -= 1
        self.ledger.add_aux(st.nid, -wire_w, now)
        self._log(now, WIRE_RELEASE, st, wire_w)
        self._power_released(now)

    def _node_down(self, now: float, st: _NodeState, data: tuple) -> None:
        """A node crashed: kill the in-flight block (record-granularity
        loss, minus checkpoint salvage), abort open transfer windows,
        release its draw (the machine keeps pulling p_idle — the service
        is down, the box is not unplugged), and run the recovery ladder
        over its orphaned queue."""
        flavor, repair_at = data
        if not st.up:
            # overlapping outage windows: the node is already down — the
            # later crash is absorbed (its NODE_UP, if any, still fires
            # and is absorbed the same way if the node already repaired)
            self._log(now, NODE_DOWN, st, flavor, "already-down")
            return
        st.up = False
        st.crashes += 1
        st.down_since = now
        rp = self.config.recovery
        fl = st.inflight
        killed = None
        burned_busy = burned_energy = salv = 0.0
        if fl is not None:
            util = float(self._t_util[fl.block_pos])
            fl.split_at(now, st.true_spec.power, util)
            burned_busy = fl.busy_s
            burned_energy = fl.energy_j
            killed = fl.block_index
            # the killed block's scheduled BLOCK_FINISH stays in the heap;
            # any relaunch (same index!) must outrun its generation
            st.gen_base = fl.generation + 1
            if rp is not None and rp.checkpoint is not None:
                salv = salvage_fraction(fl, rp.checkpoint.interval_s)
                if salv > 0.0:
                    prior = self._work_scale.get(killed, 1.0)
                    self._work_scale[killed] = prior * (1.0 - salv)
                    st.salvaged_frac += salv
            st.inflight = None
        st.failed_busy_s += burned_busy
        st.failed_energy_j += burned_energy
        st.want_up = None
        st.waiting = False
        st.pending_target = None
        st.migrate_stuck = False
        st.hw_freq = None   # power-on reset: the repaired node re-syncs
        wire_aborted = st.wire_open_w
        if wire_aborted > 0:
            # open transfer windows die with the node: release their watts
            # now and void the scheduled WIRE_RELEASEs
            self.ledger.add_aux(st.nid, -wire_aborted, now)
            st.wire_stale += st.wire_open_n
            st.wire_open_w = 0.0
            st.wire_open_n = 0
        self.ledger.set_idle(st.nid, now)
        self._log(now, NODE_DOWN, st, flavor, killed, burned_busy,
                  burned_energy, salv, wire_aborted)
        if self._mx is not None:
            self._mx.on_crash(now, st.nid, burned_busy, burned_energy)
        self._off_plan += 1   # any cached drift-scan continuation is void
        ctl = self.controller
        if ctl is not None:
            ctl.set_node_up(st.spec.name, False)
            ctl.touch(st.spec.name)
            if rp is not None:
                dec = recover_crash(ctl, st.spec.name, now, flavor=flavor,
                                    repair_at=repair_at, policy=rp,
                                    migration=self.config.migration,
                                    waits_so_far=st.recovery_waits)
                self.recoveries.append(dec)
                if dec.action == "wait":
                    st.recovery_waits += 1
                for mv in dec.moves:
                    self.migrations.append(mv)
                    st.migrated_out += 1
                    dst = self.nodes[self._id_of[mv.dst]]
                    dst.migrated_in += 1
                    # storage-pull: the RECEIVER pays the transfer energy
                    # (the dead source cannot drive the wire), no wire draw
                    dst.migrate_energy_j += mv.energy_j
                    if mv.ready_s > now + 1e-12:
                        self._mig_ready[mv.block_index] = mv.ready_s
                    self._log(now, NODE_DOWN, st, "migrate", mv.block_index,
                              mv.dst)
                    if self._mx is not None:
                        self._mx.on_migrate(now, st.nid, dst.nid, mv.energy_j)
                    if dst.inflight is None and dst.up:
                        self.queue.push(Event(now, BLOCK_START, dst.nid))
        self._power_released(now)

    def _node_up(self, now: float, st: _NodeState, data: tuple) -> None:
        """A transient crash repaired: account the outage, re-plan the
        node's surviving queue with its dead time charged, and relaunch."""
        if st.up:
            self._log(now, NODE_UP, st, "already-up")
            return
        st.up = True
        st.repairs += 1
        down = now - st.down_since
        st.down_s += down
        self._log(now, NODE_UP, st, down)
        if self._mx is not None:
            self._mx.on_repair(now, st.nid, down)
        self._off_plan += 1
        ctl = self.controller
        if ctl is not None:
            ctl.set_node_up(st.spec.name, True)
            ctl.add_dead_time(st.spec.name, down)
            ctl.touch(st.spec.name)
            if len(ctl.queued_arrays(st.spec.name)[0]):
                ctl.replan_node(st.spec.name)
        self.queue.push(Event(now, BLOCK_START, st.nid))

    def _power_released(self, now: float) -> None:
        """Cap headroom appeared: wake deferred launches, stagger clock-ups.

        Deterministic order: node id ascending; launches re-enter through
        BLOCK_START events (kind priority puts them after every same-time
        switch), clock-ups re-request through FREQ_SWITCH events.
        """
        if self.ledger.cap_w is None:
            return
        latency = self.config.actuation.latency_s
        for st in self.nodes:
            if st.waiting and st.inflight is None:
                st.waiting = False
                self.queue.push(Event(now, BLOCK_START, st.nid))
            elif st.inflight is not None and st.want_up is not None \
                    and st.pending_target is None:
                util = float(self._t_util[st.inflight.block_pos])
                f = self._highest_fitting(st, util, st.want_up)
                if f is not None and f > st.inflight.rel_freq + 1e-12:
                    target = st.want_up
                    st.want_up = None
                    st.pending_target = target
                    self.queue.push(Event(now + latency, FREQ_SWITCH,
                                          st.nid, (target,)))

    # --- main loop -----------------------------------------------------------
    def _seed_queue(self) -> None:
        """Initial events: every node's first launch, the slowdown faults,
        and the failure timeline (a transient crash schedules its own
        repair; a permanent one never comes back)."""
        for st in self.nodes:
            self.queue.push(Event(0.0, BLOCK_START, st.nid))
        for fe in self._fault_events:
            self.queue.push(Event(fe.time, FAULT, self._id_of[fe.node],
                                  (fe.factor,)))
        for fe in self._failure_events:
            nid = self._id_of[fe.node]
            repair_at = fe.repair_at
            self.queue.push(Event(fe.time, NODE_DOWN, nid,
                                  (fe.flavor, repair_at)))
            if repair_at is not None:
                self.queue.push(Event(repair_at, NODE_UP, nid))

    def run(self) -> RuntimeReport:
        if self._ran:
            raise RuntimeError("a ClusterRuntime instance runs exactly once")
        self._ran = True
        self._seed_queue()
        # BLOCK_START carries no data, so it dispatches separately
        handlers = {
            BLOCK_FINISH: self._finish_block,
            TELEMETRY: self._telemetry,
            FREQ_SWITCH: self._freq_switch,
            FAULT: self._fault,
            WIRE_RELEASE: self._wire_release,
            NODE_DOWN: self._node_down,
            NODE_UP: self._node_up,
            JOB_ARRIVAL: self._job_arrival,
        }
        while self.queue:
            ev = self.queue.pop()
            st = self.nodes[ev.node]
            if ev.kind == BLOCK_START:
                self._start_block(ev.time, st)
            else:
                handlers[ev.kind](ev.time, st, ev.data)
        return self._report()

    def _report(self) -> RuntimeReport:
        makespan = max((st.finish_s for st in self.nodes), default=0.0)
        if self._has_failures:
            # a permanently-down node's outage runs to the end of the run
            for st in self.nodes:
                if not st.up:
                    st.down_s += max(makespan, st.down_since) - st.down_since
        node_reports = tuple(
            NodeRuntimeReport(st.spec.name, st.busy_s, st.energy_j, st.done,
                              tuple(st.freqs), st.finish_s, st.n_switches,
                              st.switch_energy_j, st.migrated_in,
                              st.migrated_out, st.migrate_energy_j,
                              st.crashes, st.repairs, st.down_s,
                              st.failed_busy_s, st.failed_energy_j,
                              st.salvaged_frac)
            for st in self.nodes)
        idle = sum(max(self.deadline_s - nr.busy_s, 0.0)
                   * st.true_spec.power.p_idle
                   for nr, st in zip(node_reports, self.nodes))
        # a run only meets the deadline if it actually ran everything — a
        # power cap that permanently defers launches (or any other stall)
        # must not report an empty run as an on-time success
        planned = sum(len(npa.plan.index) for npa in self.plan.node_plans) \
            + self._extra_planned
        complete = sum(st.done for st in self.nodes) == planned
        missed: tuple = ()
        lost = 0
        if self._has_failures and not complete:
            done_set = set(self._done_idx)
            missed = tuple(sorted(
                int(i) for npa in self.plan.node_plans
                for i in npa.plan.index.tolist() if int(i) not in done_set))
            if self._t_rec is not None:
                for i in missed:
                    r = self._t_rec[self._truth_pos(i)]
                    if r is not None:
                        lost += int(r)
        rep = RuntimeReport(
            planner=self.plan.planner,
            deadline_s=self.deadline_s,
            makespan_s=makespan,
            total_energy_j=float(sum(nr.energy_j for nr in node_reports)),
            idle_energy_j=float(idle),
            deadline_met=complete and makespan <= self.deadline_s + 1e-9,
            node_reports=node_reports,
            n_replans=(self.controller.total_replans
                       if self.controller else 0),
            n_migrations=len(self.migrations),
            n_switches=sum(nr.n_switches for nr in node_reports),
            switch_energy_j=float(sum(nr.switch_energy_j
                                      for nr in node_reports)),
            migration_energy_j=float(sum(nr.migrate_energy_j
                                         for nr in node_reports)),
            peak_power_w=self.ledger.peak_w,
            power_cap_w=self.ledger.cap_w,
            migrations=tuple(self.migrations),
            event_log=tuple(self.log),
            n_crashes=sum(nr.crashes for nr in node_reports),
            n_repairs=sum(nr.repairs for nr in node_reports),
            failed_busy_s=float(sum(nr.failed_busy_s
                                    for nr in node_reports)),
            failed_energy_j=float(sum(nr.failed_energy_j
                                      for nr in node_reports)),
            missed_blocks=missed,
            lost_records=lost,
            recoveries=tuple(self.recoveries),
            power_samples=tuple(self.ledger.samples),
            events_dropped=(self.log.dropped
                            if isinstance(self.log, EventLogSink) else 0),
            event_log_mode=(self.config.event_log
                            if self.config.log_events else "off"),
        )
        if self._mx is not None:
            self._mx.on_run_end(rep)
        return rep


def run_cluster(
    plan: ClusterPlanArrays | ClusterPlan,
    truth,
    *,
    config: RuntimeConfig = RuntimeConfig(),
    events=(),
    est_blocks=None,
    true_nodes=None,
    engine: str = "auto",
) -> RuntimeReport:
    """Execute ``plan`` against true block costs on the event-driven runtime.

    ``truth`` is a ``BlockArrays`` (streamed-pipeline native) or a
    ``Sequence[BlockInfo]``; ``events`` mixes block-boundary
    ``SlowdownEvent``s and time-based ``FaultEvent``s; ``est_blocks`` seeds
    the online controller's base predictions when they differ from truth.
    ``true_nodes`` (sequence or name-keyed mapping of ``NodeSpec``) is the
    HARDWARE truth when it differs from the specs the plan was built
    against — the mis-modeled-hardware scenario ``repro_torch.calibrate`` closes:
    time prices off the true speeds, energy and the power ledger off the
    true power models, while the plan (and the online controller's belief)
    keep the planner's specs.  With ``config.trace`` /
    ``config.calibrator`` set, the actuator path emits one counter sample
    per executed block segment into the recorder / the windowed refit.

    ``engine`` selects the stepper: ``"scalar"`` is the frozen
    one-event-at-a-time oracle (this module), ``"vector"`` the batched
    fast-forward engine (``repro_torch.runtime.vector``) that commits whole
    fault-free stretches with array arithmetic, and ``"auto"`` (default)
    uses the vectorized engine — safe because it is bit-identical to the
    oracle by contract (``tests/test_runtime_vector.py``).
    """
    if engine not in ("auto", "vector", "scalar"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(pick 'auto', 'vector', or 'scalar')")
    cls = ClusterRuntime
    if engine != "scalar":
        from repro_torch.runtime.vector import VectorClusterRuntime
        cls = VectorClusterRuntime
    return cls(plan, truth, config=config, events=events,
               est_blocks=est_blocks, true_nodes=true_nodes).run()
