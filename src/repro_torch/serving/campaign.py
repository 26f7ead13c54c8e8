"""Seeded overload chaos campaign for the serving fabric.

Same discipline as ``repro_torch.runtime.failures.run_campaign``, pointed at the
open-loop serving path: every scenario draws a random small cluster, a
closed-batch base plan, a multi-tenant arrival mix sized AROUND and ABOVE
capacity (overload is the point), drifting truth, and random policy knobs
(margins, defers, quotas, provisioning, power caps, actuation latency).
Per seed the campaign checks:

  * two-run determinism — two scalar runs produce identical
    ``ServingReport``s and event logs;
  * scalar-vs-vector bit-identity — the vector engine's serving report AND
    event log equal the scalar oracle's;
  * serving conservation (``check_serving_conservation``) — every arrived
    job is exactly-once accepted-and-finished, shed-and-reported, or
    rejected-and-reported, on top of the runtime's own energy/exactly-once
    ledger audit.

The campaign NEVER raises: one bad seed reports instead of hiding the rest.

Copied from ``src/repro/serving/campaign.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.pipeline.arrivals import ArrivalSpec, TenantSpec
from repro_torch.runtime.failures import check_conservation
from repro_torch.serving.fabric import (ProvisioningPolicy, ServingConfig,
                                  ServingReport, run_serving)

__all__ = ["ServingScenario", "serving_scenario",
           "check_serving_conservation", "run_serving_campaign"]

_TERMINAL = ("accepted", "rejected", "shed")


@dataclasses.dataclass(frozen=True)
class ServingScenario:
    """One seeded scenario; ``config()`` builds a FRESH RuntimeConfig per
    call (stateful sinks must not be shared across comparison runs)."""

    seed: int
    plan: object
    truth: list
    blocks: list
    events: list
    arrivals: ArrivalSpec
    serving: ServingConfig
    arrival_truth: float
    _cfg_kwargs: dict

    def config(self):
        from repro_torch.runtime.engine import RuntimeConfig
        return RuntimeConfig(**dict(self._cfg_kwargs))


def serving_scenario(seed: int) -> ServingScenario:
    """Random cluster + base batch + overloadable multi-tenant traffic.

    Crash-free by design: node failures change the meaning of "every
    accepted job finishes" (crash-missed blocks are the failures
    campaign's contract); here the stress is load, drift, caps, and
    actuation — the serving fabric's own failure modes.
    """
    from repro_torch.cluster.node import NodeSpec
    from repro_torch.cluster.planner import plan_cluster
    from repro_torch.core.energy import FrequencyLadder, PowerModel
    from repro_torch.core.scheduler import BlockInfo
    from repro_torch.runtime.actuator import ActuationModel
    from repro_torch.runtime.events import FaultEvent

    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 16))
    blocks = [
        BlockInfo(index=i,
                  est_time_fmax=float(rng.uniform(0.3, 1.5)),
                  est_rel_halfwidth=float(rng.uniform(0, 0.15)),
                  util=float(rng.uniform(0.5, 1.0)),
                  records=float(rng.integers(50, 800)))
        for i in range(n)]
    k = int(rng.integers(2, 5))
    ladder = FrequencyLadder((0.5, 0.7, 0.85, 1.0))
    nodes = [NodeSpec(f"n{j}", ladder=ladder,
                      power=PowerModel(p_idle=28 + 3 * j, p_full=105 + 9 * j,
                                       alpha=float(rng.uniform(1.6, 2.6))),
                      speed=float(rng.uniform(0.85, 1.25)))
             for j in range(k)]
    deadline = sum(b.est_time_fmax for b in blocks) / k \
        * float(rng.uniform(1.4, 2.2))
    plan = plan_cluster(blocks, nodes, deadline_s=deadline)
    truth = [dataclasses.replace(
        b, est_time_fmax=b.est_time_fmax * float(rng.uniform(0.85, 1.25)))
        for b in blocks]

    # traffic sized against capacity: offered load spans under- to 2x-over
    horizon = deadline * float(rng.uniform(0.8, 1.6))
    n_tenants = int(rng.integers(2, 4))
    cap_hz = k / 3.0   # very rough jobs/s the cluster digests (~3 s jobs)
    load = float(rng.uniform(0.4, 2.0))
    prios = rng.permutation(np.arange(1, n_tenants + 1)).astype(float)
    tenants = []
    for i in range(n_tenants):
        kind = "burst" if rng.random() < 0.4 else "poisson"
        kw = {}
        if kind == "burst":
            t0 = float(rng.uniform(0.0, 0.5)) * horizon
            kw = dict(burst_factor=float(rng.uniform(2.0, 8.0)),
                      burst_start_s=t0,
                      burst_end_s=t0 + float(rng.uniform(0.1, 0.3)) * horizon)
        tenants.append(TenantSpec(
            name=f"t{i}",
            rate_hz=load * cap_hz / n_tenants * float(rng.uniform(0.5, 1.5)),
            slo_s=float(rng.uniform(4.0, 14.0)),
            priority=float(prios[i]),
            blocks_per_job=(1, int(rng.integers(1, 4))),
            block_time_s=(0.4, float(rng.uniform(1.0, 2.5))),
            records_per_block=float(rng.integers(0, 300)),
            process=kind, **kw))
    arrivals = ArrivalSpec(tenants=tuple(tenants), horizon_s=horizon,
                           seed=seed)

    prov = None
    if rng.random() < 0.5:
        prov = ProvisioningPolicy(
            wake_latency_s=float(rng.choice([0.0, 0.3, 1.0])),
            wake_energy_j=float(rng.choice([0.0, 5.0])),
            park_below=float(rng.uniform(0.1, 0.3)),
            wake_above=float(rng.uniform(0.6, 1.2)),
            min_awake=1)
    serving = ServingConfig(
        admission=bool(rng.random() < 0.9),
        shedding=bool(rng.random() < 0.9),
        margin=float(rng.choice([0.05, 0.1, 0.2])),
        max_defers=int(rng.integers(0, 3)),
        backoff_frac=float(rng.choice([0.1, 0.25, 0.5])),
        quota_frac=float(rng.choice([0.34, 0.5, 0.75])),
        provisioning=prov)

    events: list = []
    for _ in range(int(rng.integers(0, 3))):
        events.append(FaultEvent(
            time=float(rng.uniform(0.1, 0.8)) * horizon,
            node=f"n{int(rng.integers(0, k))}",
            factor=float(rng.uniform(1.1, 1.7))))

    idle_floor = sum(nd.power.p_idle for nd in nodes)
    cap = None
    if rng.random() < 0.3:
        cap = idle_floor + float(rng.uniform(0.8, 1.6)) * \
            sum(nd.power.p_full - nd.power.p_idle for nd in nodes) / k
    cfg_kwargs = dict(
        online=True, log_events=True, power_cap_w=cap,
        actuation=ActuationModel(
            latency_s=float(rng.choice([0.0, 0.0, 0.15])),
            switch_energy_j=float(rng.choice([0.0, 0.1]))))
    return ServingScenario(
        seed=seed, plan=plan, truth=truth, blocks=blocks, events=events,
        arrivals=arrivals, serving=serving,
        arrival_truth=float(rng.uniform(0.9, 1.3)),
        _cfg_kwargs=cfg_kwargs)


def check_serving_conservation(sreport: ServingReport, plan, *,
                               rel_tol: float = 1e-9) -> list:
    """Audit a serving run; returns violation strings (empty == held).

    On top of the runtime ledger audit (``failures.check_conservation``
    with accepted jobs' blocks as ``planned_extra`` — so a shed or
    rejected job whose blocks still finish is flagged as a stray):

      * every job lands in exactly one terminal status;
      * non-accepted jobs never finish and never count an SLO;
      * accepted jobs' ``t_finish``/``slo_met`` agree with the event log;
      * the headline counters and per-tenant stats are exactly the fold
        of the per-job records.
    """
    errs: list = []
    acc_blocks: list = []
    fin_t: dict = {}
    fin_n: dict = {}
    block_job = {b: j.job_id for j in sreport.jobs for b in j.blocks}
    for row in sreport.event_log:
        if row[1] != "block_finish":
            continue
        j = block_job.get(int(row[3]))
        if j is not None:
            fin_n[j] = fin_n.get(j, 0) + 1
            fin_t[j] = max(fin_t.get(j, float("-inf")), float(row[0]))

    agg: dict = {}
    for j in sreport.jobs:
        if j.status not in _TERMINAL:
            errs.append(f"job {j.job_id}: non-terminal status {j.status!r}")
            continue
        if j.status == "accepted":
            acc_blocks.extend(j.blocks)
            done = fin_n.get(j.job_id, 0) == len(j.blocks)
            want_t = fin_t[j.job_id] if done else -1.0
            if j.t_finish != want_t:
                errs.append(f"job {j.job_id}: t_finish {j.t_finish!r} "
                            f"disagrees with the event log ({want_t!r})")
            want_met = done and want_t <= j.deadline_s + 1e-9
            if j.slo_met != want_met:
                errs.append(f"job {j.job_id}: slo_met {j.slo_met!r} "
                            f"inconsistent with finish time")
        else:
            if fin_n.get(j.job_id):
                errs.append(f"job {j.job_id}: {j.status} but "
                            f"{fin_n[j.job_id]} of its blocks finished")
            if j.t_finish != -1.0 or j.slo_met:
                errs.append(f"job {j.job_id}: {j.status} but carries a "
                            f"finish time / SLO credit")
        s = agg.setdefault(j.tenant, dict(arrived=0, accepted=0, rejected=0,
                                          shed=0, finished=0, slo_miss=0))
        s["arrived"] += 1
        s[j.status] += 1
        if j.status == "accepted":
            if j.t_finish >= 0:
                s["finished"] += 1
            if not j.slo_met:
                s["slo_miss"] += 1

    for name, want in (("n_accepted", sum(s["accepted"]
                                          for s in agg.values())),
                       ("n_rejected", sum(s["rejected"]
                                          for s in agg.values())),
                       ("n_shed", sum(s["shed"] for s in agg.values()))):
        got = getattr(sreport, name)
        if got != want:
            errs.append(f"{name}={got} but per-job fold says {want}")
    seen = {t.tenant: t for t in sreport.tenants}
    if set(seen) != set(agg):
        errs.append(f"tenant set mismatch: report {sorted(seen)} vs "
                    f"jobs {sorted(agg)}")
    else:
        for t, s in sorted(agg.items()):
            ts = seen[t]
            for fld, want in s.items():
                if getattr(ts, fld) != want:
                    errs.append(f"tenant {t}: {fld}={getattr(ts, fld)} "
                                f"but per-job fold says {want}")

    errs.extend(check_conservation(sreport.runtime, plan, rel_tol=rel_tol,
                                   planned_extra=acc_blocks))
    return errs


def run_serving_campaign(n_scenarios: int = 50, base_seed: int = 0, *,
                         check_vector: bool = True) -> dict:
    """Run ``n_scenarios`` seeded overload scenarios; returns a summary."""
    violations: list = []
    n_jobs = n_accepted = n_rejected = n_shed = n_missed = 0
    for s in range(n_scenarios):
        sc = serving_scenario(base_seed + s)

        def _one(engine):
            return run_serving(sc.plan, sc.truth, sc.arrivals,
                               config=sc.config(), serving=sc.serving,
                               arrival_truth=sc.arrival_truth,
                               events=sc.events, est_blocks=sc.blocks,
                               engine=engine)

        a = _one("scalar")
        b = _one("scalar")
        if a != b or a.event_log != b.event_log:
            violations.append(f"seed {sc.seed}: two scalar runs differ")
        if check_vector:
            v = _one("vector")
            if a != v:
                violations.append(f"seed {sc.seed}: scalar != vector "
                                  f"serving report")
            elif a.event_log != v.event_log:
                violations.append(f"seed {sc.seed}: scalar != vector "
                                  f"event log")
        for err in check_serving_conservation(a, sc.plan):
            violations.append(f"seed {sc.seed}: {err}")
        n_jobs += len(a.jobs)
        n_accepted += a.n_accepted
        n_rejected += a.n_rejected
        n_shed += a.n_shed
        n_missed += sum(1 for j in a.jobs
                        if j.status == "accepted" and not j.slo_met)
    return {"n_scenarios": n_scenarios, "violations": violations,
            "n_jobs": n_jobs, "n_accepted": n_accepted,
            "n_rejected": n_rejected, "n_shed": n_shed,
            "accepted_misses": n_missed}
