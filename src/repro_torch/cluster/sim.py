"""Cluster execution simulator — compatibility surface over the runtime.

``simulate_cluster`` keeps its original signature and ``ClusterReport``
shape but is now a thin wrapper over the event-driven engine in
``repro_torch.runtime``: with the defaults (no power cap, zero actuation latency,
no migration) the engine reproduces the original block-boundary loop
bit-for-bit, and the extra engine capabilities are exposed as optional
keywords (``migrate``, ``actuation``, ``power_cap_w``; time-based
``FaultEvent``s may be mixed into ``events``).  Use
``repro_torch.runtime.run_cluster`` directly for the full ``RuntimeReport``
(event log, migrations, peak power).

``SlowdownEvent`` injects the classic mid-run fault: from the moment a node
has finished ``after_block`` blocks, its true processing times are
multiplied by ``factor`` (co-tenant interference, thermal throttling, a
failing disk).  Multiple events on one node apply in the total order
``(after_block, factor)`` — NOT in input order, which used to silently
decide the product's floating-point rounding when triggers tied.

``simulate_cluster_reference`` preserves the original per-node Python loop
(same event ordering fix) as the equivalence oracle the runtime is tested
against — do not use it in hot paths.

Copied from ``src/repro/cluster/sim.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.scheduler import BlockInfo
from repro_torch.cluster.controller import OnlineReplanner
from repro_torch.cluster.planner import ClusterPlan

__all__ = ["SlowdownEvent", "NodeReport", "ClusterReport",
           "simulate_cluster", "simulate_cluster_reference"]


@dataclasses.dataclass(frozen=True)
class SlowdownEvent:
    """From the node's ``after_block``-th completion on, times ×= ``factor``."""

    node: str
    after_block: int
    factor: float


@dataclasses.dataclass(frozen=True)
class NodeReport:
    name: str
    busy_s: float
    energy_j: float
    n_blocks: int
    freqs: tuple


@dataclasses.dataclass(frozen=True)
class ClusterReport:
    planner: str
    deadline_s: float
    makespan_s: float
    total_energy_j: float        # busy-only, summed over nodes (formula 7)
    idle_energy_j: float         # every node's idle tail up to the deadline
    deadline_met: bool
    node_reports: tuple
    n_replans: int = 0

    def improvement_vs(self, other: "ClusterReport") -> float:
        """Fractional busy-energy improvement of self over ``other``."""
        if other.total_energy_j <= 0:
            return 0.0
        return 1.0 - self.total_energy_j / other.total_energy_j


def simulate_cluster(
    plan: ClusterPlan,
    true_blocks: Sequence[BlockInfo],
    *,
    est_blocks: Sequence[BlockInfo] | None = None,
    online: bool = False,
    events: Sequence = (),
    replan_threshold: float = 0.15,
    ewma_alpha: float = 0.3,
    error_margin: float = 0.05,
    migrate: bool = False,
    actuation=None,
    power_cap_w: float | None = None,
) -> ClusterReport:
    """Execute ``plan`` against true block costs (thin engine wrapper).

    ``true_blocks`` mirror the planner's blocks with ``est_time_fmax`` set to
    the actual f_max time (what sampling only estimated).  ``est_blocks``
    default to ``true_blocks`` and seed the online controller's base
    predictions; pass the planner's estimates when they differ from the
    truth.  ``migrate``/``actuation``/``power_cap_w`` switch on the engine's
    migration policy, actuation model, and cluster power cap (see
    ``repro_torch.runtime``); ``migrate=True`` implies ``online``.
    """
    from repro_torch.runtime.actuator import ActuationModel
    from repro_torch.runtime.engine import RuntimeConfig, run_cluster
    online = online or migrate
    cfg = RuntimeConfig(
        online=online, migrate=migrate,
        actuation=actuation if actuation is not None else ActuationModel(),
        power_cap_w=power_cap_w, replan_threshold=replan_threshold,
        ewma_alpha=ewma_alpha, error_margin=error_margin, log_events=False)
    rt = run_cluster(
        plan, true_blocks, config=cfg, events=events,
        est_blocks=(est_blocks if est_blocks is not None else true_blocks)
        if online else None)
    return ClusterReport(
        planner=rt.planner,
        deadline_s=rt.deadline_s,
        makespan_s=rt.makespan_s,
        total_energy_j=rt.total_energy_j,
        idle_energy_j=rt.idle_energy_j,
        deadline_met=rt.deadline_met,
        node_reports=tuple(NodeReport(nr.name, nr.busy_s, nr.energy_j,
                                      nr.n_blocks, nr.freqs)
                           for nr in rt.node_reports),
        n_replans=rt.n_replans,
    )


def simulate_cluster_reference(
    plan: ClusterPlan,
    true_blocks: Sequence[BlockInfo],
    *,
    est_blocks: Sequence[BlockInfo] | None = None,
    online: bool = False,
    events: Sequence[SlowdownEvent] = (),
    replan_threshold: float = 0.15,
    ewma_alpha: float = 0.3,
    error_margin: float = 0.05,
) -> ClusterReport:
    """The original block-boundary loop — the runtime's equivalence oracle.

    Nodes run their queues independently; the only runtime capability it
    models is the count-based ``SlowdownEvent`` (applied, like the engine,
    in ``(after_block, factor)`` order).  ``tests/test_runtime.py`` asserts
    the engine reproduces this loop bit-for-bit at zero actuation latency
    with no cap; keep the two in lockstep when touching either.
    """
    truth = {b.index: b for b in true_blocks}
    controller = None
    if online:
        controller = OnlineReplanner(
            plan, est_blocks if est_blocks is not None else true_blocks,
            replan_threshold=replan_threshold, ewma_alpha=ewma_alpha,
            error_margin=error_margin)
    ev_by_node: dict = {}
    for ev in events:
        ev_by_node.setdefault(ev.node, []).append(ev)
    for evs in ev_by_node.values():
        # total order shared with the runtime: same-trigger events cannot
        # apply in whatever order the caller happened to list them
        evs.sort(key=lambda ev: (ev.after_block, ev.factor))

    node_reports = []
    for np_ in plan.node_plans:
        node = np_.node
        busy = 0.0
        energy = 0.0
        freqs = []
        done = 0
        static_queue = list(np_.blocks)
        while True:
            bp = controller.next_block(node.name) if controller else \
                (static_queue[0] if static_queue else None)
            if bp is None:
                break
            factor = 1.0
            for ev in ev_by_node.get(node.name, ()):
                if done >= ev.after_block:
                    factor *= ev.factor
            t = node.block_time(truth[bp.index], bp.rel_freq) * factor
            energy += node.block_energy(truth[bp.index], t, bp.rel_freq)
            busy += t
            freqs.append(bp.rel_freq)
            done += 1
            if controller:
                controller.observe(node.name, t)
            else:
                static_queue.pop(0)
        node_reports.append(NodeReport(node.name, busy, energy, done,
                                       tuple(freqs)))

    makespan = max((nr.busy_s for nr in node_reports), default=0.0)
    idle = sum(max(plan.deadline_s - nr.busy_s, 0.0) * np_.node.power.p_idle
               for nr, np_ in zip(node_reports, plan.node_plans))
    return ClusterReport(
        planner=plan.planner,
        deadline_s=plan.deadline_s,
        makespan_s=makespan,
        total_energy_j=float(sum(nr.energy_j for nr in node_reports)),
        idle_energy_j=float(idle),
        deadline_met=makespan <= plan.deadline_s + 1e-9,
        node_reports=tuple(node_reports),
        n_replans=controller.total_replans if controller else 0,
    )
