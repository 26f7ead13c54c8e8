"""Admission + scheduling fabric: open-loop arrivals on the runtime engine.

The closed-batch runtime executes a fixed plan against one deadline.  This
module makes it an online server that stays stable under ANY offered load:

  admission   — every ``JOB_ARRIVAL`` is answered at arrival time with
                accept / defer-with-backoff / reject, from a deadline-
                feasibility test priced off the planner's own
                ``(n_blocks, n_states)`` time tables (per candidate node:
                wall-clock ready time + table-priced job seconds at f_max,
                drift-corrected).  The system never promises an SLO it
                cannot meet at decision time;
  backpressure + shedding — when drift or bursts make accepted promises
                stale, a deterministic policy drops the lowest-value
                not-yet-started work first (value = priority x remaining
                slack), with per-tenant isolation quotas: a tenant whose
                outstanding accepted work is within its quota share never
                loses a still-feasible job to another tenant's burst;
  rolling horizon — every accepted job re-plans the landing node's tail
                (behind any in-flight block) against the earliest active
                deadline on that node, wall-clock anchored;
  elastic provisioning — nodes park (p_idle-free) under low load and wake
                against backlog with hysteresis; a wake pays a latency and
                an energy charge priced like actuation.

Invariants (enforced by ``tests/test_serving.py`` + the overload campaign):
the vector engine stays bit-identical to the scalar oracle — report AND
event log — under arrivals, admission, shedding, and provisioning; with no
arrivals the serving runtimes ARE the closed-batch runtimes, bitwise; and
every arrived job is exactly-once accepted-and-finished, shed-and-reported,
or rejected-and-reported (``repro_torch.serving.campaign``).

Copied from ``src/repro/serving/fabric.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scheduler import block_time_table_arrays
from repro_torch.core.soa import BlockArrays
from repro_torch.pipeline.arrivals import (ArrivalSpec, JobArrival,
                                     generate_arrivals)
from repro_torch.runtime.engine import ClusterRuntime, RuntimeConfig, RuntimeReport
from repro_torch.runtime.events import BLOCK_START, JOB_ARRIVAL, Event
from repro_torch.runtime.vector import VectorClusterRuntime

__all__ = ["ProvisioningPolicy", "ServingConfig", "JobRecord", "TenantStats",
           "ServingReport", "ServingFabric", "ServingRuntime",
           "VectorServingRuntime", "run_serving"]


@dataclasses.dataclass(frozen=True)
class ProvisioningPolicy:
    """Elastic node provisioning against load, with hysteresis.

    Load factor = total predicted backlog seconds / (awake nodes x
    reference window).  Above ``wake_above`` a parked node wakes; below
    ``park_below`` a drained node parks.  ``park_below < wake_above`` is
    the hysteresis band that stops flapping.  A parked node draws zero
    watts (its ``p_idle`` leaves the ledger); waking costs
    ``wake_latency_s`` before the node can launch and ``wake_energy_j``
    charged like an actuation transition.
    """

    wake_latency_s: float = 0.0
    wake_energy_j: float = 0.0
    park_below: float = 0.25
    wake_above: float = 0.75
    window_s: float | None = None   # None: mean tenant SLO of the schedule
    min_awake: int = 1

    def __post_init__(self):
        if self.wake_latency_s < 0 or self.wake_energy_j < 0:
            raise ValueError("wake latency/energy must be >= 0")
        if not 0 <= self.park_below < self.wake_above:
            raise ValueError(
                f"need 0 <= park_below < wake_above (the hysteresis band), "
                f"got {self.park_below!r} / {self.wake_above!r}")
        if self.window_s is not None and not self.window_s > 0:
            raise ValueError("window_s must be positive (or None)")
        if self.min_awake < 1:
            raise ValueError("min_awake must be >= 1")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Fabric policy knobs.

    margin:       fraction of a job's SLO reserved at admission — the
                  feasibility test requires predicted finish <=
                  deadline - margin * slo;
    max_defers:   defer-with-backoff retries before a final reject;
    backoff_frac: defer delay as a fraction of the job's SLO;
    quota_frac:   per-tenant isolation share — a tenant is shed-eligible
                  while still predicted feasible only when its outstanding
                  accepted work exceeds this fraction of the cluster's;
    admission=False accepts everything on the least-loaded node (the
    baseline that collapses under overload); shedding=False never drops
    accepted work; replan=False skips the rolling-horizon tail re-plan.
    """

    admission: bool = True
    shedding: bool = True
    replan: bool = True
    margin: float = 0.1
    max_defers: int = 1
    backoff_frac: float = 0.25
    quota_frac: float = 0.5
    provisioning: ProvisioningPolicy | None = None

    def __post_init__(self):
        if not 0 <= self.margin < 1:
            raise ValueError("margin must be in [0, 1)")
        if self.max_defers < 0:
            raise ValueError("max_defers must be >= 0")
        if not self.backoff_frac > 0:
            raise ValueError("backoff_frac must be positive")
        if not 0 < self.quota_frac <= 1:
            raise ValueError("quota_frac must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """One job's final accounting (``t_finish`` is -1.0 when it never
    finished — rejected, shed, or still unfinished at run end)."""

    job_id: int
    tenant: str
    priority: float
    time: float
    deadline_s: float
    blocks: tuple        # the job's global block indices
    status: str          # accepted | rejected | shed
    node: str            # landing node ("" unless accepted)
    attempts: int        # defer retries taken
    t_finish: float
    slo_met: bool


@dataclasses.dataclass(frozen=True)
class TenantStats:
    tenant: str
    arrived: int
    accepted: int
    rejected: int
    shed: int
    finished: int
    slo_miss: int        # accepted jobs that missed (or never finished)
    miss_rate: float     # slo_miss / accepted (0.0 when none accepted)


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """The runtime report plus the serving ledger on top of it."""

    runtime: RuntimeReport
    jobs: tuple                  # JobRecord per job, job_id order
    tenants: tuple               # TenantStats, tenant-name order
    provisioning: tuple          # (time, node, "wake"|"park") flips, in order
    n_accepted: int
    n_rejected: int
    n_shed: int
    n_deferred: int              # defer decisions taken (retries)
    accepted_miss_rate: float    # jobs that missed / jobs accepted
    wake_energy_j: float
    parked_s: tuple              # (node, parked seconds), node order
    parked_saved_j: float        # p_idle joules the parked intervals saved

    @property
    def event_log(self):
        return self.runtime.event_log


class _JobState:
    __slots__ = ("arrival", "block_idx", "status", "node", "attempts",
                 "ba", "blocks_set")

    def __init__(self, arrival: JobArrival, block_idx: tuple):
        self.arrival = arrival
        self.block_idx = block_idx
        self.blocks_set = frozenset(block_idx)
        self.status = "pending"
        self.node = ""
        self.attempts = 0
        est = np.asarray(arrival.block_times, dtype=np.float64)
        rec = (np.full(len(est), arrival.records_per_block)
               if arrival.records_per_block else None)
        self.ba = BlockArrays.build(
            est, index=np.asarray(block_idx, dtype=np.int64), records=rec)


class ServingFabric:
    """All serving state + policy; driven by ``JOB_ARRIVAL`` handler calls.

    Every decision reads only state that is identical between the scalar
    and vector engines at the event's position in the total order, and
    every mutation goes through the same controller/ledger entry points on
    both — which is how the bit-identity contract survives serving.
    """

    def __init__(self, schedule, cfg: ServingConfig, *,
                 arrival_truth: float = 1.0):
        if not np.isfinite(arrival_truth) or arrival_truth <= 0:
            raise ValueError("arrival_truth must be a positive factor")
        self.schedule = tuple(schedule)
        ids = [ja.job_id for ja in self.schedule]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate job_id in the arrival schedule")
        self.cfg = cfg
        self.prov = cfg.provisioning
        self.arrival_truth = arrival_truth
        self.jobs: dict = {}
        self._job_of_block: dict = {}
        self._tab_cache: dict = {}
        self._ready_at: dict = {}
        self.parked: set = set()
        self._parked_since: dict = {}
        self._parked_s: dict = {}
        self.provision_log: list = []
        self.n_rejected = 0
        self.n_shed = 0
        self.n_deferred = 0
        self.wake_energy_j = 0.0
        self.base_deadline = 0.0
        self._slo_ref = 1.0

    # --- wiring --------------------------------------------------------------
    def attach(self, eng: ClusterRuntime) -> None:
        """Bind to an engine BEFORE ``run()``: number the arrival blocks
        past every closed-batch index and register the arrival schedule.
        Touches no engine numerics — a zero-arrival attach leaves the run
        bitwise the closed-batch run."""
        eng._fabric = self
        self.base_deadline = eng.deadline_s
        nxt = int(eng._t_index.max()) + 1 if len(eng._t_index) else 0
        for ja in self.schedule:
            idxs = tuple(range(nxt, nxt + len(ja.block_times)))
            nxt += len(ja.block_times)
            job = _JobState(ja, idxs)
            self.jobs[ja.job_id] = job
            for bi in idxs:
                self._job_of_block[bi] = ja.job_id
        if self.schedule:
            slos = [ja.deadline_s - ja.time for ja in self.schedule]
            self._slo_ref = sum(slos) / len(slos)
        for st in eng.nodes:
            self._parked_s[st.spec.name] = 0.0

    # --- pricing helpers -----------------------------------------------------
    def _job_time_on(self, eng, name: str, job: _JobState) -> float:
        """The job's predicted seconds on ``name``: the planner's own time
        table at the node's f_max, over node speed, drift-corrected."""
        ctl = eng.controller
        spec = ctl.node_spec_of(name)
        states = tuple(spec.ladder.states)
        key = (job.arrival.job_id, states)
        tab = self._tab_cache.get(key)
        if tab is None:
            tab = block_time_table_arrays(job.ba, states)
            self._tab_cache[key] = tab
        col = int(np.argmax(np.asarray(states)))
        return float(np.sum(tab[:, col])) / spec.speed * ctl.drift_of(name)

    def _ready_end(self, eng, now: float, name: str) -> float:
        """Wall-clock time ``name`` would finish everything already on it."""
        ctl = eng.controller
        st = eng.nodes[eng._id_of[name]]
        start = now
        if st.inflight is not None:
            start = max(start, st.inflight.seg_start + st.inflight.seg_time)
        ra = self._ready_at.get(name)
        if ra is not None and ra > start:
            start = ra
        terms = ctl.queued_pred_times(name)
        if len(terms):
            idx, _ = ctl.queued_arrays(name)
            if st.inflight is not None \
                    and int(idx[0]) == st.inflight.block_index:
                terms = terms[1:]   # the head IS the in-flight block
            if len(terms):
                start = start + float(np.sum(terms))
        return start

    def _awake(self, eng) -> list:
        return [st for st in eng.nodes
                if st.up and st.spec.name not in self.parked]

    def _place(self, eng, now: float, job: _JobState):
        """Best feasible landing: ``(node_name, needs_wake)`` or None."""
        slo = job.arrival.deadline_s - job.arrival.time
        bound = job.arrival.deadline_s - self.cfg.margin * slo
        best = None
        for st in self._awake(eng):
            name = st.spec.name
            fin = self._ready_end(eng, now, name) \
                + self._job_time_on(eng, name, job)
            if fin <= bound + 1e-9 and (best is None or fin < best[0] - 1e-12):
                best = (fin, name, False)
        if best is None and self.prov is not None and self.parked:
            for name in sorted(self.parked, key=lambda n: eng._id_of[n]):
                st = eng.nodes[eng._id_of[name]]
                if not st.up:
                    continue
                fin = now + self.prov.wake_latency_s \
                    + self._job_time_on(eng, name, job)
                if fin <= bound + 1e-9 \
                        and (best is None or fin < best[0] - 1e-12):
                    best = (fin, name, True)
        if best is None:
            return None
        return best[1], best[2]

    def _least_loaded(self, eng, now: float) -> str:
        """No-admission placement: earliest predicted-ready awake node."""
        best = None
        for st in self._awake(eng):
            name = st.spec.name
            end = self._ready_end(eng, now, name)
            if best is None or end < best[0] - 1e-12:
                best = (end, name)
        return best[1]

    # --- the JOB_ARRIVAL handler ---------------------------------------------
    def on_arrival(self, eng, now: float, job_id: int, attempt: int) -> None:
        job = self.jobs[job_id]
        if job.status != "pending":
            return
        cfg = self.cfg
        if not cfg.admission:
            name = self._least_loaded(eng, now)
            self._accept(eng, now, job, name)
            decision, where = "accept", name
        else:
            choice = self._place(eng, now, job)
            if choice is not None:
                name, needs_wake = choice
                if needs_wake:
                    self._wake(eng, now, name)
                self._accept(eng, now, job, name)
                decision, where = "accept", name
            elif attempt < cfg.max_defers:
                slo = job.arrival.deadline_s - job.arrival.time
                eng.queue.push(Event(now + cfg.backoff_frac * slo,
                                     JOB_ARRIVAL, 0, (job_id, attempt + 1)))
                job.attempts = attempt + 1
                self.n_deferred += 1
                decision, where = "defer", "-"
            else:
                job.status = "rejected"
                job.attempts = attempt
                self.n_rejected += 1
                decision, where = "reject", "-"
        if eng._log_on:
            eng.log.append((now, "job_arrival", where,
                            (job_id, job.arrival.tenant, decision, attempt)))
        if eng._mx is not None:
            eng._mx.on_job(now, job.arrival.tenant, decision,
                           slo_s=job.arrival.deadline_s - job.arrival.time)
        if cfg.shedding:
            self._shed_pass(eng, now)
        if self.prov is not None:
            self._provision(eng, now)

    def _accept(self, eng, now: float, job: _JobState, name: str) -> None:
        ctl = eng.controller
        est = job.ba.est_time_fmax
        truth_extra = BlockArrays.build(
            est * self.arrival_truth,
            index=np.asarray(job.block_idx, dtype=np.int64),
            records=job.ba.records)
        ctl.extend_base(job.ba)
        eng._extend_truth(truth_extra)
        ctl.append_blocks(name, job.block_idx)
        eng._extra_planned += len(job.block_idx)
        if eng._mx is not None:
            eng._mx.on_accept(now, eng._id_of[name], len(job.block_idx))
        job.status = "accepted"
        job.node = name
        nst = eng.nodes[eng._id_of[name]]
        if self.cfg.replan:
            idx, _ = ctl.queued_arrays(name)
            dl = job.arrival.deadline_s
            for bi in idx.tolist():
                j = self._job_of_block.get(int(bi))
                dl = min(dl, self.jobs[j].arrival.deadline_s
                         if j is not None else self.base_deadline)
            start = now
            skip = False
            if nst.inflight is not None:
                start = max(start,
                            nst.inflight.seg_start + nst.inflight.seg_time)
                if len(idx) and int(idx[0]) == nst.inflight.block_index:
                    skip = True
            ra = self._ready_at.get(name)
            if ra is not None and ra > start:
                start = ra
            ctl.replan_node(name, budget_s=max(dl - start, 1e-9),
                            skip_head=skip)
        ctl.set_horizon(max(ctl.deadline_s, job.arrival.deadline_s))
        if nst.inflight is None and nst.up and not nst.waiting:
            start_at = now
            ra = self._ready_at.get(name)
            if ra is not None and ra > start_at:
                start_at = ra
            eng.queue.push(Event(start_at, BLOCK_START, nst.nid))

    # --- backpressure + SLO-aware shedding -----------------------------------
    def _walks(self, eng, now: float):
        """One pass over every awake node's priced queue: per-job predicted
        finish, per-tenant outstanding accepted seconds, total backlog."""
        ctl = eng.controller
        job_fin: dict = {}
        outstanding: dict = {}
        backlog = 0.0
        for st in self._awake(eng):
            name = st.spec.name
            start = now
            if st.inflight is not None:
                start = max(start,
                            st.inflight.seg_start + st.inflight.seg_time)
            ra = self._ready_at.get(name)
            if ra is not None and ra > start:
                start = ra
            idx, _ = ctl.queued_arrays(name)
            if not len(idx):
                backlog += max(start - now, 0.0)
                continue
            terms = ctl.queued_pred_times(name)
            if st.inflight is not None \
                    and int(idx[0]) == st.inflight.block_index:
                terms = terms.copy()
                terms[0] = 0.0
            fin = start + np.cumsum(terms)
            backlog += max(float(fin[-1]) - now, 0.0)
            for p, bi in enumerate(idx.tolist()):
                j = self._job_of_block.get(int(bi))
                if j is None:
                    continue
                f = float(fin[p])
                if f > job_fin.get(j, float("-inf")):
                    job_fin[j] = f
                tn = self.jobs[j].arrival.tenant
                outstanding[tn] = outstanding.get(tn, 0.0) + float(terms[p])
        return job_fin, outstanding, backlog

    def _sheddable(self, eng, job: _JobState) -> bool:
        """Only never-started jobs shed: every block still queued on the
        landing node, none in flight (and none migrated away)."""
        if job.status != "accepted":
            return False
        st = eng.nodes[eng._id_of[job.node]]
        if st.inflight is not None \
                and st.inflight.block_index in job.blocks_set:
            return False
        idx, _ = eng.controller.queued_arrays(job.node)
        qs = set(idx.tolist())
        return all(b in qs for b in job.block_idx)

    def _shed_pass(self, eng, now: float) -> None:
        """Drop lowest-value work until every remaining accepted job is
        predicted feasible (or nothing eligible remains).

        Victim preference encodes the isolation quota: jobs of over-quota
        tenants first (the burster pays for its own burst); after that only
        jobs that are themselves predicted to miss (shedding the doomed
        harms nobody).  A still-feasible job of an under-quota tenant is
        never shed.
        """
        cfg = self.cfg
        while True:
            job_fin, outstanding, _ = self._walks(eng, now)
            late = sorted(
                j for j, f in job_fin.items()
                if self.jobs[j].status == "accepted"
                and f > self.jobs[j].arrival.deadline_s + 1e-9)
            if not late:
                return
            total = sum(outstanding.values())
            over = {t for t, v in sorted(outstanding.items())
                    if total > 0 and v / total > cfg.quota_frac + 1e-12}
            cands = [j for j in sorted(self.jobs)
                     if self._sheddable(eng, self.jobs[j])]
            pool = [j for j in cands if self.jobs[j].arrival.tenant in over]
            if not pool:
                late_set = set(late)
                pool = [j for j in cands if j in late_set]
            if not pool:
                return      # late work is running or protected: it just runs
            victim = min(
                pool,
                key=lambda j: (self.jobs[j].arrival.priority
                               * max(self.jobs[j].arrival.deadline_s - now,
                                     0.0), j))
            self._shed(eng, now, self.jobs[victim])

    def _shed(self, eng, now: float, job: _JobState) -> None:
        eng.controller.drop_blocks(job.node, job.block_idx)
        eng._extra_planned -= len(job.block_idx)
        job.status = "shed"
        self.n_shed += 1
        if eng._log_on:
            eng.log.append((now, "job_shed", job.node,
                            (job.arrival.job_id, job.arrival.tenant)))
        if eng._mx is not None:
            eng._mx.on_shed(now, eng._id_of[job.node], job.arrival.tenant,
                            len(job.block_idx))

    # --- elastic provisioning ------------------------------------------------
    def _provision(self, eng, now: float) -> None:
        pol = self.prov
        awake = self._awake(eng)
        if not awake:
            return
        backlog = sum(max(self._ready_end(eng, now, st.spec.name) - now, 0.0)
                      for st in awake)
        window = pol.window_s if pol.window_s is not None else self._slo_ref
        rho = backlog / max(len(awake) * window, 1e-9)
        if rho > pol.wake_above and self.parked:
            name = min(self.parked, key=lambda n: eng._id_of[n])
            if eng.nodes[eng._id_of[name]].up:
                self._wake(eng, now, name)
        elif rho < pol.park_below and len(awake) > pol.min_awake:
            for st in sorted(awake, key=lambda s: -s.nid):
                name = st.spec.name
                if st.inflight is None and not st.waiting \
                        and not len(eng.controller.queued_arrays(name)[0]):
                    self._park(eng, now, name)
                    break

    def _park(self, eng, now: float, name: str) -> None:
        nid = eng._id_of[name]
        eng.ledger._idle[nid] = 0.0
        eng.ledger.set_draw(nid, 0.0, now)
        self.parked.add(name)
        self._parked_since[name] = now
        self.provision_log.append((now, name, "park"))
        if eng._log_on:
            eng.log.append((now, "provision", name, ("park",)))
        if eng._mx is not None:
            eng._mx.on_provision(now, nid, "park")

    def _wake(self, eng, now: float, name: str) -> None:
        nid = eng._id_of[name]
        st = eng.nodes[nid]
        p_idle = st.true_spec.power.p_idle
        eng.ledger._idle[nid] = p_idle
        eng.ledger.set_draw(nid, p_idle, now)
        self.parked.discard(name)
        self._parked_s[name] += now - self._parked_since.pop(name)
        self._ready_at[name] = now + self.prov.wake_latency_s
        # the wake transition is priced like an actuation switch
        st.switch_energy_j += self.prov.wake_energy_j
        self.wake_energy_j += self.prov.wake_energy_j
        self.provision_log.append((now, name, "wake"))
        if eng._log_on:
            eng.log.append((now, "provision", name, ("wake",)))
        if eng._mx is not None:
            eng._mx.on_provision(now, nid, "wake")

    # --- final accounting ----------------------------------------------------
    def finalize(self, rep: RuntimeReport) -> ServingReport:
        """Fold the run's event log into per-job / per-tenant outcomes.
        Both engines produce identical logs, so this is engine-agnostic."""
        end = rep.makespan_s
        for name, since in sorted(self._parked_since.items()):
            self._parked_s[name] += max(end, since) - since
        self._parked_since.clear()

        fin_t: dict = {}
        fin_n: dict = {}
        for row in rep.event_log:
            if row[1] != "block_finish":
                continue
            j = self._job_of_block.get(int(row[3]))
            if j is None:
                continue
            fin_n[j] = fin_n.get(j, 0) + 1
            t = float(row[0])
            if t > fin_t.get(j, float("-inf")):
                fin_t[j] = t

        recs = []
        per_tenant: dict = {}
        for jid in sorted(self.jobs):
            job = self.jobs[jid]
            ja = job.arrival
            n = len(job.block_idx)
            done = fin_n.get(jid, 0) == n and n > 0
            t_fin = fin_t[jid] if done else -1.0
            met = bool(done and t_fin <= ja.deadline_s + 1e-9)
            # a job still pending at run end was deferred past the last
            # event: account it as rejected (its final retry never found
            # capacity before the queue drained)
            status = job.status
            if status == "pending":
                status = "rejected"
                self.n_rejected += 1
            recs.append(JobRecord(
                job_id=jid, tenant=ja.tenant, priority=ja.priority,
                time=ja.time, deadline_s=ja.deadline_s, blocks=job.block_idx,
                status=status, node=job.node if status == "accepted" else "",
                attempts=job.attempts, t_finish=t_fin, slo_met=met))
            s = per_tenant.setdefault(
                ja.tenant, {"arrived": 0, "accepted": 0, "rejected": 0,
                            "shed": 0, "finished": 0, "slo_miss": 0})
            s["arrived"] += 1
            s[status] += 1
            if done:
                s["finished"] += 1
            if status == "accepted" and not met:
                s["slo_miss"] += 1

        tenants = tuple(
            TenantStats(tenant=t, miss_rate=(s["slo_miss"] / s["accepted"]
                                             if s["accepted"] else 0.0), **s)
            for t, s in sorted(per_tenant.items()))
        n_acc = sum(s.accepted for s in tenants)
        n_miss = sum(s.slo_miss for s in tenants)
        saved = 0.0
        parked = []
        # parked seconds are real p_idle joules the runtime report still
        # charges (its idle figure assumes every node idles at p_idle)
        for st_name, secs in sorted(self._parked_s.items()):
            parked.append((st_name, secs))
        return ServingReport(
            runtime=rep,
            jobs=tuple(recs),
            tenants=tenants,
            provisioning=tuple(self.provision_log),
            n_accepted=n_acc,
            n_rejected=self.n_rejected,
            n_shed=self.n_shed,
            n_deferred=self.n_deferred,
            accepted_miss_rate=(n_miss / n_acc if n_acc else 0.0),
            wake_energy_j=self.wake_energy_j,
            parked_s=tuple(parked),
            parked_saved_j=saved,
            )


class _ServingMixin:
    """Engine hook-ins: seed the arrival schedule, route ``JOB_ARRIVAL`` to
    the fabric.  With no fabric (or an empty schedule) nothing is added —
    the run IS the closed-batch run, bitwise."""

    _fabric: ServingFabric | None = None

    def _seed_queue(self):
        super()._seed_queue()
        if self._fabric is not None:
            for ja in self._fabric.schedule:
                self.queue.push(Event(ja.time, JOB_ARRIVAL, 0,
                                      (ja.job_id, 0)))

    def _job_arrival(self, now, st, data):
        self._fabric.on_arrival(self, now, int(data[0]), int(data[1]))


class ServingRuntime(_ServingMixin, ClusterRuntime):
    pass


class VectorServingRuntime(_ServingMixin, VectorClusterRuntime):
    pass


def run_serving(
    plan,
    truth,
    arrivals,
    *,
    config: RuntimeConfig,
    serving: ServingConfig = ServingConfig(),
    arrival_truth: float = 1.0,
    events=(),
    est_blocks=None,
    true_nodes=None,
    engine: str = "auto",
) -> ServingReport:
    """Open-loop serving run: the closed-batch ``run_cluster`` contract
    plus an arrival stream.

    ``arrivals`` is an ``ArrivalSpec`` (expanded deterministically) or an
    explicit ``JobArrival`` schedule.  ``arrival_truth`` scales arrived
    blocks' TRUE times against their estimates (the planner's belief) —
    the drift that makes shedding earn its keep.  Serving needs the online
    controller and the event log (job outcomes are read off it).
    """
    if engine not in ("auto", "vector", "scalar"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(pick 'auto', 'vector', or 'scalar')")
    if not config.online:
        raise ValueError("serving needs the online controller "
                         "(RuntimeConfig(online=True))")
    if not config.log_events:
        raise ValueError("serving needs log_events=True — job outcomes "
                         "are read off the event log")
    if config.event_log != "full":
        raise ValueError("serving needs event_log='full' — finalize() "
                         "replays the whole log for job outcomes (the "
                         "ring/off modes cannot answer it)")
    schedule = generate_arrivals(arrivals) \
        if isinstance(arrivals, ArrivalSpec) else tuple(arrivals)
    cls = ServingRuntime if engine == "scalar" else VectorServingRuntime
    eng = cls(plan, truth, config=config, events=events,
              est_blocks=est_blocks, true_nodes=true_nodes)
    fab = ServingFabric(schedule, serving, arrival_truth=arrival_truth)
    fab.attach(eng)
    rep = eng.run()
    sr = fab.finalize(rep)
    # parked p_idle joules actually saved (the runtime idle figure assumes
    # p_idle everywhere): computed here so the report stays a pure record
    saved = 0.0
    for name, secs in sr.parked_s:
        st = eng.nodes[eng._id_of[name]]
        saved += secs * st.true_spec.power.p_idle
    return dataclasses.replace(sr, parked_saved_j=saved)
