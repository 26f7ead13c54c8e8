"""Cluster demo — DV-DVFS on heterogeneous nodes, offline, online, runtime.

1. plan one Zipf-variety workload across heterogeneous nodes (LPT assignment
   + cross-node greedy down-clock) and compare against per-node independent
   Algorithm 1 on a round-robin split at the same deadline,
2. hit one node with a mid-run 2x slowdown and watch the online re-planner
   (EWMA drift feedback) clock the late node up and still meet the deadline
   that the static plan misses,
3. hit it with a 4x slowdown instead — clocking up to f_max cannot recover
   that — and watch the event-driven runtime (repro_torch.runtime) migrate
   queued blocks to the nodes with slack and still meet the deadline,
4. crash a node permanently mid-run: without a recovery policy its orphaned
   queue is simply lost; with one, the ladder checkpoints the in-flight
   block, evacuates the queue to the survivors with the most slack, and the
   cluster still meets the deadline,
5. serve an open-loop two-tenant arrival stream through a 10x overload
   burst: with every job blindly accepted the backlog snowballs and BOTH
   tenants' SLOs collapse; with admission control + SLO-aware shedding the
   damage is contained to the bursting tenant's own rejected jobs and the
   steady tenant never misses,
6. ask the run itself what each mechanism bought: deterministic
   counterfactual replays ablate DVFS / migration / the power cap /
   actuation one at a time and ledger the exact per-channel energy delta
   (the DVFS row IS the paper's headline, measured on this very run), and
   an SRE-style burn-rate watchdog replays the same run's metrics into a
   deterministic alert stream.

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_sim

Copied from ``examples/cluster_sim.py`` with its imports pointed at
``repro_torch``: NumPy only, so it prints the reference's text.  Each demo
also returns its reports, and ``main`` returns them by demo.
"""
import dataclasses

import numpy as np

from repro_torch.cluster import (NodeSpec, SlowdownEvent, assign_blocks,
                                 plan_cluster, plan_independent,
                                 simulate_cluster)
from repro_torch.core import BlockInfo, FrequencyLadder, zipf_block_sizes
from repro_torch.obs import (Scenario, StreamingMetrics, Watchdog,
                             format_table, mechanism_columns, node_rows,
                             profile_mechanisms, standard_rules, tenant_rows)
from repro_torch.pipeline import ArrivalSpec, TenantSpec
from repro_torch.runtime import (ActuationModel, CheckpointModel,
                                 MigrationModel, NodeFailureEvent,
                                 RecoveryPolicy, RuntimeConfig, run_cluster)
from repro_torch.serving import ServingConfig, run_serving


def offline_demo():
    print("=== 1) Multi-node planning vs independent Algorithm 1 ===")
    sizes = zipf_block_sizes(24, 100_000, z=1.0, seed=0)
    costs = sizes / sizes.mean() * 5.0           # seconds at f_max, reference
    blocks = [BlockInfo(i, float(c)) for i, c in enumerate(costs)]
    nodes = [NodeSpec("a", speed=1.0), NodeSpec("b", speed=0.7),
             NodeSpec("c", speed=1.3), NodeSpec("d", speed=0.9)]
    rr = assign_blocks(blocks, nodes, strategy="round_robin")
    deadline = max(sum(b.est_time_fmax for b in g) / n.speed
                   for g, n in zip(rr, nodes)) * 1.2

    ind = simulate_cluster(plan_independent(blocks, nodes, deadline), blocks)
    clu = simulate_cluster(plan_cluster(blocks, nodes, deadline), blocks)
    print(f"  independent: energy {ind.total_energy_j:8.0f} J  "
          f"makespan {ind.makespan_s:5.1f}s  met={ind.deadline_met}")
    print(f"  cluster    : energy {clu.total_energy_j:8.0f} J  "
          f"makespan {clu.makespan_s:5.1f}s  met={clu.deadline_met}  "
          f"(-{clu.improvement_vs(ind):.1%})")
    return {"independent": ind, "cluster": clu}


def online_demo():
    print("=== 2) Online re-planning under a mid-run 2x slowdown ===")
    deep = FrequencyLadder(
        states=tuple(round(f, 2) for f in np.arange(0.35, 1.001, 0.05)))
    blocks = [BlockInfo(i, 5.0) for i in range(24)]
    nodes = [NodeSpec("n0", speed=1.0, ladder=deep),
             NodeSpec("n1", speed=0.8, ladder=deep),
             NodeSpec("n2", speed=1.25, ladder=deep)]
    mk = max(sum(b.est_time_fmax for b in g) / n.speed
             for g, n in zip(assign_blocks(blocks, nodes), nodes))
    deadline = mk * 2.2
    plan = plan_cluster(blocks, nodes, deadline, assignment="lpt")
    n0 = plan.node_plans[0]
    events = [SlowdownEvent("n0", after_block=len(n0.blocks) // 2 - 1,
                            factor=2.0)]

    static = simulate_cluster(plan, blocks, events=events)
    online = simulate_cluster(plan, blocks, events=events, online=True,
                              ewma_alpha=0.7, replan_threshold=0.1)
    print(f"  deadline {deadline:5.1f}s; n0 slows 2x mid-run")
    print(f"  static : makespan {static.makespan_s:5.1f}s  "
          f"met={static.deadline_met}")
    print(f"  online : makespan {online.makespan_s:5.1f}s  "
          f"met={online.deadline_met}  replans={online.n_replans}")
    n0_rep = [nr for nr in online.node_reports if nr.name == "n0"][0]
    print(f"  n0 frequencies: {[round(f, 2) for f in n0_rep.freqs]} "
          f"(clocked up after the drift was detected)")
    return {"static": static, "online": online}


def migration_demo():
    print("=== 3) Cross-node migration when f_max cannot recover ===")
    deep = FrequencyLadder(
        states=tuple(round(f, 2) for f in np.arange(0.35, 1.001, 0.05)))
    blocks = [BlockInfo(i, 5.0) for i in range(24)]
    nodes = [NodeSpec("n0", speed=1.0, ladder=deep),
             NodeSpec("n1", speed=0.8, ladder=deep),
             NodeSpec("n2", speed=1.25, ladder=deep)]
    mk = max(sum(b.est_time_fmax for b in g) / n.speed
             for g, n in zip(assign_blocks(blocks, nodes), nodes))
    deadline = mk * 2.2
    plan = plan_cluster(blocks, nodes, deadline, assignment="lpt")
    n0 = plan.node_plans[0]
    events = [SlowdownEvent("n0", after_block=len(n0.blocks) // 2 - 1,
                            factor=4.0)]
    kw = dict(ewma_alpha=0.7, replan_threshold=0.1)
    static = run_cluster(plan, blocks, events=events)
    online = run_cluster(plan, blocks, events=events, est_blocks=blocks,
                         config=RuntimeConfig(online=True, **kw))
    mx = StreamingMetrics()
    mig = run_cluster(plan, blocks, events=events, est_blocks=blocks,
                      config=RuntimeConfig(online=True, migrate=True,
                                           metrics=mx, **kw))

    print(f"  deadline {deadline:5.1f}s; n0 slows 4x mid-run")
    print(f"  static        : makespan {static.makespan_s:6.1f}s  "
          f"met={static.deadline_met}")
    print(f"  online (f_max): makespan {online.makespan_s:6.1f}s  "
          f"met={online.deadline_met}  replans={online.n_replans}")
    print(f"  + migration   : makespan {mig.makespan_s:6.1f}s  "
          f"met={mig.deadline_met}  moves={mig.n_migrations}")
    for mv in mig.migrations:
        print(f"      t={mv.time:5.1f}s  block {mv.block_index:2d}  "
              f"{mv.src} -> {mv.dst}")
    print("  per-node outcome (with migration):")
    print(format_table(node_rows(mig),
                       [("node", "node", "s"), ("blocks", "blocks", "d"),
                        ("in", "in", "d"), ("out", "out", "d"),
                        ("busy_s", "busy_s", ".1f"),
                        ("finish_s", "finish_s", ".1f"),
                        ("energy_j", "energy_j", ".0f"),
                        ("state", "deadline", "s")]))
    snap = mx.snapshot()
    print(f"  streamed inline: peak draw {snap['peak_power_w']:.0f} W, "
          f"block SLO attainment {snap['slo_attainment']:.1%}")
    return {"static": static, "online": online, "migration": mig}


def crash_recovery_demo():
    print("=== 4) Node crash mid-run: work salvage + survivor re-plan ===")
    deep = FrequencyLadder(
        states=tuple(round(f, 2) for f in np.arange(0.35, 1.001, 0.05)))
    blocks = [BlockInfo(i, 5.0, records=5000.0) for i in range(24)]
    nodes = [NodeSpec("n0", speed=1.0, ladder=deep),
             NodeSpec("n1", speed=0.8, ladder=deep),
             NodeSpec("n2", speed=1.25, ladder=deep)]
    mk = max(sum(b.est_time_fmax for b in g) / n.speed
             for g, n in zip(assign_blocks(blocks, nodes), nodes))
    deadline = mk * 2.2
    plan = plan_cluster(blocks, nodes, deadline, assignment="lpt")
    crash = [NodeFailureEvent(time=0.33 * deadline, node="n0",
                              flavor="permanent")]
    kw = dict(online=True, migrate=True, ewma_alpha=0.7,
              replan_threshold=0.1,
              migration=MigrationModel(latency_s_per_block=0.5,
                                       energy_j_per_record=0.005))
    bare = run_cluster(plan, blocks, events=crash, est_blocks=blocks,
                       config=RuntimeConfig(**kw))
    rec = run_cluster(plan, blocks, events=crash, est_blocks=blocks,
                      config=RuntimeConfig(**kw, recovery=RecoveryPolicy(
                          checkpoint=CheckpointModel(
                              interval_s=0.04 * deadline))))

    print(f"  deadline {deadline:5.1f}s; n0 dies for good at "
          f"t={crash[0].time:.1f}s")
    print(f"  no recovery : makespan {bare.makespan_s:6.1f}s  "
          f"met={bare.deadline_met}  "
          f"lost blocks={len(bare.missed_blocks)} "
          f"({bare.lost_records:,} records)")
    print(f"  recovery    : makespan {rec.makespan_s:6.1f}s  "
          f"met={rec.deadline_met}  "
          f"lost blocks={len(rec.missed_blocks)}  "
          f"moves={rec.n_migrations}")
    for dec in rec.recoveries:
        print(f"      t={dec.time:5.1f}s  {dec.node} ({dec.flavor}) -> "
              f"{dec.action}: "
              f"{[(mv.block_index, mv.dst) for mv in dec.moves]}")
    print("  per-node outcome (with recovery):")
    print(format_table(node_rows(rec),
                       [("node", "node", "s"), ("blocks", "blocks", "d"),
                        ("in", "in", "d"), ("out", "out", "d"),
                        ("salvage", "salvage", ".2f"),
                        ("busy_s", "busy_s", ".1f"),
                        ("energy_j", "energy_j", ".0f"),
                        ("state", "deadline", "s")]))
    return {"bare": bare, "recovery": rec}


def overload_serving_demo():
    print("=== 5) Overload burst: admission control + SLO-aware shedding ===")
    ladder = FrequencyLadder((0.5, 0.7, 0.85, 1.0))
    rng = np.random.default_rng(0)
    blocks = [BlockInfo(i, float(rng.uniform(0.3, 0.7)), records=500.0)
              for i in range(6)]
    nodes = [NodeSpec(f"n{j}", ladder=ladder) for j in range(3)]
    deadline = sum(b.est_time_fmax for b in blocks) / 3 * 1.8
    plan = plan_cluster(blocks, nodes, deadline)

    spec = ArrivalSpec(
        tenants=(TenantSpec(name="steady", rate_hz=0.8, slo_s=6.0,
                            priority=2.0, blocks_per_job=(1, 1),
                            block_time_s=(0.8, 1.2)),
                 TenantSpec(name="bursty", rate_hz=0.8, slo_s=6.0,
                            priority=1.0, blocks_per_job=(1, 1),
                            block_time_s=(0.8, 1.2), process="burst",
                            burst_factor=10.0, burst_start_s=10.0,
                            burst_end_s=20.0)),
        horizon_s=40.0, seed=5)
    cfg = RuntimeConfig(online=True, log_events=True)
    naked = run_serving(plan, blocks, spec, config=cfg, est_blocks=blocks,
                        serving=ServingConfig(admission=False,
                                              shedding=False))
    guarded = run_serving(plan, blocks, spec, config=cfg, est_blocks=blocks,
                          serving=ServingConfig(margin=0.15))

    print(f"  two tenants at ~0.8 jobs/s each on 3 nodes; 'bursty' spikes "
          f"10x for t=10..20s")
    cols = [("policy", "policy", "s"), ("tenant", "tenant", "s"),
            ("arrived", "arrived", "d"), ("accepted", "accepted", "d"),
            ("rejected", "rejected", "d"), ("shed", "shed", "d"),
            ("slo_miss", "slo_miss", "d"), ("miss_rate", "miss_rate", ".1%")]
    rows = [dict(r, policy=tag)
            for tag, rep in (("accept-all", naked),
                             ("admission+shed", guarded))
            for r in tenant_rows(rep)]
    print(format_table(rows, cols, indent="  "))
    print(f"  accept-all     : every job admitted, miss rate "
          f"{naked.accepted_miss_rate:.1%} — the burst sinks BOTH tenants")
    print(f"  admission+shed : miss rate {guarded.accepted_miss_rate:.1%}; "
          f"the burst is paid by the bursty tenant's "
          f"{guarded.n_rejected} rejects, the steady tenant keeps its SLO")
    return {"accept_all": naked, "guarded": guarded}


def counterfactual_demo():
    print("=== 6) Counterfactuals: what did each mechanism buy, exactly ===")
    ladder = FrequencyLadder((0.6, 0.8, 1.0))
    blocks = [BlockInfo(i, 5.0, records=5000.0) for i in range(24)]
    nodes = [NodeSpec("n0", speed=1.0, ladder=ladder),
             NodeSpec("n1", speed=0.8, ladder=ladder),
             NodeSpec("n2", speed=1.25, ladder=ladder)]
    mk = max(sum(b.est_time_fmax for b in g) / n.speed
             for g, n in zip(assign_blocks(blocks, nodes), nodes))
    deadline = mk * 1.35
    plan = plan_cluster(blocks, nodes, deadline, assignment="lpt")
    n0 = plan.node_plans[0]
    events = [SlowdownEvent("n0", after_block=len(n0.blocks) // 2 - 1,
                            factor=2.0)]
    cfg = RuntimeConfig(online=True, migrate=True, ewma_alpha=0.7,
                        replan_threshold=0.1, power_cap_w=400.0,
                        actuation=ActuationModel(latency_s=0.05,
                                                 switch_energy_j=2.0),
                        migration=MigrationModel(latency_s_per_block=0.5,
                                                 energy_j_per_record=0.005))
    sc = Scenario(plan=plan, truth=blocks, config=cfg, events=tuple(events),
                  est_blocks=blocks)

    # each row: the identical run replayed with ONE mechanism off, on both
    # engines (report identity asserted); positive delta = the ablated run
    # pays more, i.e. the mechanism was saving that much on THIS run
    rows = profile_mechanisms(sc)
    print("  per-mechanism exact ledger (ablated minus base):")
    print(format_table([r for r in rows if r["changed"]],
                       mechanism_columns(), indent="  "))
    dvfs = next(r for r in rows if r["mechanism"] == "dvfs")
    print(f"  the dvfs row is the paper's claim on this very run: pinning "
          f"f_max costs {dvfs['d_busy_j']:+.0f} J of busy energy")
    mig = next(r for r in rows if r["mechanism"] == "migration")
    if mig["d_total_j"] == 0.0:
        print("  the all-zero migration row is a finding too: the clock-up "
              "absorbed the 2x drift, so migration bought nothing here")

    # the same run, watched: burn-rate rules over the streamed metrics
    mx = StreamingMetrics()
    wd = Watchdog(standard_rules(deadline)).attach(mx)
    sc.run(engine="vector", metrics=mx)
    print(f"  watchdog ({len(wd.alerts)} alerts, deterministic):")
    for a in wd.alerts[:4]:
        print(f"      t={a.time:5.1f}s  [{a.severity}] {a.rule}: "
              f"burn {a.value:.2f}x over {a.window_s:.1f}s window")
    return {"rows": rows, "alerts": wd.alerts}


DEMOS = (offline_demo, online_demo, migration_demo, crash_recovery_demo,
         overload_serving_demo, counterfactual_demo)


def main() -> dict:
    """Every demo in turn; their reports by demo name."""
    return {demo.__name__: demo() for demo in DEMOS}


if __name__ == "__main__":
    main()
