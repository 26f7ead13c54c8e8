"""Multi-node DV-DVFS planner.

Extends the single-node greedy down-clock loop (``repro.core.scheduler``,
planner ``global``) across a heterogeneous cluster:

1. **Assignment** — sampled blocks are placed on nodes.  ``lpt`` (longest
   processing time first onto the earliest-finishing node, speed-aware) is the
   variety-aware default: it balances *estimated work*, which is exactly the
   per-block signal Algorithm 1's sampling pass produces.  ``round_robin``
   ignores both variety and node speed — it is the Data-Variety/heterogeneity-
   oblivious splitter real Big-Data stacks default to, kept as the baseline.
   An explicit per-block node index list pins blocks to nodes (used by the
   serving engine, where decode streams cannot migrate).

2. **Cross-node greedy down-clock** — every (node, block) pair starts at that
   node's f_max; one shared max-heap repeatedly takes the single down-step
   anywhere in the cluster with the best energy-saved / time-added ratio,
   subject to each node finishing within ``deadline * (1 - error_margin)``.
   Nodes run in parallel, so the constraint is per-node finish time, not the
   sum — but the *choice* of which step to take is global, so a node with a
   coarser ladder or a steeper power curve competes for the same slack pool on
   equal ΔE/Δt terms.

The variety-oblivious baseline (``plan_independent``) runs the paper's
Algorithm 1 per node on a round-robin split: each node gets an equal *count*
of blocks regardless of estimated cost or node speed, then plans its own
frequencies under the shared deadline.

Copied from ``src/repro/cluster/planner.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Sequence

import numpy as np

from repro_torch.core.scheduler import (BlockInfo, BlockPlan,
                                  _run_downclock_tables,
                                  block_time_table_arrays, busy_energy_table,
                                  plan_dvfs)
from repro_torch.core.soa import BlockArrays, PlanArrays
from repro_torch.cluster.node import NodeSpec

__all__ = ["NodePlan", "ClusterPlan", "NodePlanArrays", "ClusterPlanArrays",
           "assign_blocks", "assign_block_arrays", "plan_cluster",
           "plan_cluster_arrays", "plan_independent"]


@dataclasses.dataclass(frozen=True)
class NodePlan:
    """One node's share of a cluster plan (times are node-local seconds)."""

    node: NodeSpec
    blocks: tuple

    @functools.cached_property
    def pred_finish_s(self) -> float:
        return sum(b.pred_time_s for b in self.blocks)

    @functools.cached_property
    def pred_energy_j(self) -> float:
        return sum(b.pred_energy_j for b in self.blocks)

    def to_arrays(self, deadline_s: float) -> "NodePlanArrays":
        """SoA form of this node plan (the runtime engine's native input).

        The per-node feasible flag is THIS node's deadline verdict (as
        ``plan_cluster_arrays`` produces), not the cluster-level one.
        """
        n = len(self.blocks)
        slot = self.blocks[0].slot_s if self.blocks else deadline_s
        pull = lambda attr, dt: np.fromiter(
            (getattr(b, attr) for b in self.blocks), dt, count=n)
        return NodePlanArrays(self.node, PlanArrays(
            "cluster", deadline_s, slot, pull("index", np.int64),
            pull("rel_freq", np.float64), pull("pred_time_s", np.float64),
            pull("pred_energy_j", np.float64),
            bool(self.pred_finish_s <= deadline_s + 1e-9)))


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    planner: str
    deadline_s: float
    node_plans: tuple
    feasible: bool
    power_cap_ok: bool = True    # plan-time Σ-power screen (True when uncapped)

    @functools.cached_property
    def pred_makespan_s(self) -> float:
        return max((np_.pred_finish_s for np_ in self.node_plans), default=0.0)

    @functools.cached_property
    def pred_total_energy(self) -> float:
        return sum(np_.pred_energy_j for np_ in self.node_plans)

    def assignment(self) -> dict:
        """block index -> node name."""
        out = {}
        for np_ in self.node_plans:
            for bp in np_.blocks:
                out[bp.index] = np_.node.name
        return out

    def to_arrays(self) -> "ClusterPlanArrays":
        """SoA form (what ``repro.runtime`` consumes natively)."""
        return ClusterPlanArrays(
            self.planner, self.deadline_s,
            tuple(np_.to_arrays(self.deadline_s)
                  for np_ in self.node_plans),
            self.feasible, self.power_cap_ok)


def assign_blocks(
    blocks: Sequence[BlockInfo],
    nodes: Sequence[NodeSpec],
    *,
    strategy="lpt",
    deadline_s: float | None = None,
) -> list:
    """Split ``blocks`` across ``nodes``; returns a list of block-lists.

    ``strategy`` is ``"lpt"``, ``"pack"``, ``"round_robin"``, or an explicit
    sequence of node indices (one per block).  All are deterministic: sorts
    use (estimated time desc, block index asc) and ties go to the lower node
    index, so a fixed input always yields the same assignment.

    ``pack`` (needs ``deadline_s``) consolidates work onto the fastest nodes
    up to their deadline capacity at f_max: busy energy scales with busy
    TIME, so a fast node at f_max can beat a slow node at the energy-optimal
    clock — the makespan-minimizing spread of LPT is not always the
    energy-minimizing one.  Blocks that fit nowhere fall back to the LPT
    rule (earliest finish including the block).
    """
    groups = [[] for _ in nodes]
    if isinstance(strategy, str):
        if strategy == "round_robin":
            for i, b in enumerate(blocks):
                groups[i % len(nodes)].append(b)
        elif strategy == "pack":
            if deadline_s is None:
                raise ValueError("pack assignment needs deadline_s")
            order = sorted(blocks, key=lambda b: (-b.est_time_fmax, b.index))
            by_speed = sorted(range(len(nodes)),
                              key=lambda k: (-nodes[k].speed, k))
            loads = [0.0] * len(nodes)
            for b in order:
                placed = False
                for k in by_speed:
                    t = b.est_time_fmax / nodes[k].speed
                    if loads[k] + t <= deadline_s + 1e-9:
                        groups[k].append(b)
                        loads[k] += t
                        placed = True
                        break
                if not placed:  # overloaded everywhere: earliest finish
                    k = min(range(len(nodes)), key=lambda j: (
                        loads[j] + b.est_time_fmax / nodes[j].speed, j))
                    groups[k].append(b)
                    loads[k] += b.est_time_fmax / nodes[k].speed
        elif strategy == "lpt":
            # uniform-machine LPT: place each block (largest first) on the
            # node whose finish time INCLUDING the block is earliest — on
            # heterogeneous speeds the earliest-available node is not the
            # earliest-finishing one (a giant block belongs on a fast node
            # even if that node already has work)
            order = sorted(blocks, key=lambda b: (-b.est_time_fmax, b.index))
            loads = [0.0] * len(nodes)
            for b in order:
                k = min(range(len(nodes)),
                        key=lambda j: (loads[j] + b.est_time_fmax / nodes[j].speed, j))
                groups[k].append(b)
                loads[k] += b.est_time_fmax / nodes[k].speed
        else:
            raise ValueError(f"unknown assignment strategy: {strategy}")
    else:
        idxs = list(strategy)
        if len(idxs) != len(blocks):
            raise ValueError("explicit assignment must name a node per block")
        for b, k in zip(blocks, idxs):
            groups[int(k)].append(b)
    return groups


@dataclasses.dataclass(frozen=True)
class NodePlanArrays:
    """SoA ``NodePlan``: one node's share of a cluster plan, zero per-block
    objects (``plan`` holds index/rel_freq/time/energy arrays)."""

    node: NodeSpec
    plan: PlanArrays

    @functools.cached_property
    def pred_finish_s(self) -> float:
        # python sum over the same block order as NodePlan.pred_finish_s,
        # so auto-assignment tie-breaks cannot diverge from the object path
        return sum(self.plan.pred_time_s.tolist())

    @functools.cached_property
    def pred_energy_j(self) -> float:
        return sum(self.plan.pred_energy_j.tolist())

    def to_node_plan(self) -> NodePlan:
        return NodePlan(self.node, self.plan.to_blocks())


@dataclasses.dataclass(frozen=True)
class ClusterPlanArrays:
    """SoA ``ClusterPlan`` — what ``plan_cluster`` returns for ``BlockArrays``
    input.  ``to_cluster_plan()`` materializes the object form on demand."""

    planner: str
    deadline_s: float
    node_plans: tuple  # of NodePlanArrays
    feasible: bool
    power_cap_ok: bool = True  # plan-time Σ-power screen (True when uncapped)

    def to_arrays(self) -> "ClusterPlanArrays":
        return self  # runtime-entry symmetry with ClusterPlan.to_arrays

    @functools.cached_property
    def pred_makespan_s(self) -> float:
        return max((np_.pred_finish_s for np_ in self.node_plans), default=0.0)

    @functools.cached_property
    def pred_total_energy(self) -> float:
        return sum(np_.pred_energy_j for np_ in self.node_plans)

    def assignment(self) -> dict:
        """block index -> node name."""
        out = {}
        for np_ in self.node_plans:
            for i in np_.plan.index.tolist():
                out[i] = np_.node.name
        return out

    def to_cluster_plan(self) -> ClusterPlan:
        return ClusterPlan(self.planner, self.deadline_s,
                           tuple(np_.to_node_plan() for np_ in self.node_plans),
                           self.feasible, self.power_cap_ok)


def _assign_lpt_grouped(nodes, order, est_list, groups, strategy,
                        by_speed, deadline_s):
    """Earliest-finish placement at fleet scale; exact loop equivalent.

    The reference loop takes ``min_j (loads[j] + e / speed_j, j)`` per
    block — O(nodes) of Python tuple churn per placement.  Within one
    *speed*, finish is monotone in load, so a lazy min-heap of
    ``(load, j)`` per distinct speed knows each speed's minimal finish
    VALUE, and the cross-speed minimum is a vectorized argmin over one
    ``best_load + e / speed`` array (same divides, same floats).  The
    winning NODE needs care: two loads can differ yet round to the same
    finish (``15.9 + 2.3 == 15.899999999999999 + 2.3``), and the tuple
    compare breaks ties on (finish, j) — so every group at the minimal
    finish pop-walks its heap over the entries whose finish equals it
    (a prefix, by monotonicity) and the smallest node id wins.
    """
    k_nodes = len(nodes)
    speeds = np.array([nd.speed for nd in nodes])
    loads = np.zeros(k_nodes)
    gid_of = {}
    g_of = np.empty(k_nodes, dtype=np.int64)
    for j, nd in enumerate(nodes):
        g_of[j] = gid_of.setdefault(nd.speed, len(gid_of))
    n_g = len(gid_of)
    sp = np.empty(n_g)
    for s_val, g in gid_of.items():
        sp[g] = s_val
    gheaps: list = [[] for _ in range(n_g)]
    for j in range(k_nodes):
        gheaps[int(g_of[j])].append((0.0, j))
    for h in gheaps:
        heapq.heapify(h)
    best_load = np.zeros(n_g)
    pack = strategy == "pack"
    if pack:
        bys = np.asarray(by_speed, dtype=np.int64)
        sp_bys = speeds[bys]
    for p in order.tolist():
        e = est_list[p]
        k = -1
        if pack:
            ok = np.nonzero(loads[bys] + e / sp_bys
                            <= deadline_s + 1e-9)[0]
            if len(ok):
                k = int(bys[ok[0]])
        if k < 0:  # lpt rule (also pack's overloaded fallback)
            f = best_load + e / sp
            g = int(f.argmin())
            m = f[g]
            for g in np.nonzero(f == m)[0].tolist():
                h = gheaps[g]
                eos = float(e / sp[g])
                stash = []
                while h:
                    l0, j0 = h[0]
                    if l0 != loads[j0]:
                        heapq.heappop(h)   # stale (load has grown since)
                        continue
                    if l0 + eos != m:
                        break
                    heapq.heappop(h)
                    stash.append((l0, j0))
                    if k < 0 or j0 < k:
                        k = j0
                for it in stash:
                    heapq.heappush(h, it)
        groups[k].append(p)
        loads[k] += e / speeds[k]
        g = int(g_of[k])
        h = gheaps[g]
        heapq.heappush(h, (loads[k], k))
        # discard entries priced at a stale (smaller) load on sight
        while h[0][0] != loads[h[0][1]]:
            heapq.heappop(h)
        best_load[g] = h[0][0]
    return [np.asarray(gr, dtype=np.int64) for gr in groups]


def assign_block_arrays(
    ba: BlockArrays,
    nodes: Sequence[NodeSpec],
    *,
    strategy="lpt",
    deadline_s: float | None = None,
) -> list:
    """``assign_blocks`` over SoA input; returns per-node POSITION arrays.

    Group contents and order are identical to what ``assign_blocks`` produces
    on the corresponding ``BlockInfo`` list (same sort keys, same FP finish
    times, same tie rules), so the two paths plan the same splits.
    ``round_robin`` and explicit assignments are pure array ops; ``lpt`` /
    ``pack`` keep the reference's sequential placement loop (exact earliest-
    finish semantics) over scalars — prefer ``round_robin`` or an explicit
    assignment in the million-block regime.
    """
    n = len(ba)
    est = ba.est_time_fmax
    if isinstance(strategy, str):
        if strategy == "round_robin":
            return [np.arange(k, n, len(nodes)) for k in range(len(nodes))]
        if strategy in ("lpt", "pack"):
            if strategy == "pack" and deadline_s is None:
                raise ValueError("pack assignment needs deadline_s")
            order = np.lexsort((ba.index, -est))
            groups = [[] for _ in nodes]
            by_speed = sorted(range(len(nodes)),
                              key=lambda k: (-nodes[k].speed, k))
            est_list = est.tolist()
            if len(nodes) > 8:
                return _assign_lpt_grouped(nodes, order, est_list, groups,
                                           strategy, by_speed, deadline_s)
            loads = [0.0] * len(nodes)
            for p in order.tolist():
                e = est_list[p]
                k = None
                if strategy == "pack":
                    for cand in by_speed:
                        if loads[cand] + e / nodes[cand].speed \
                                <= deadline_s + 1e-9:
                            k = cand
                            break
                if k is None:  # lpt rule (also pack's overloaded fallback)
                    k = min(range(len(nodes)),
                            key=lambda j: (loads[j] + e / nodes[j].speed, j))
                groups[k].append(p)
                loads[k] += e / nodes[k].speed
            return [np.asarray(g, dtype=np.int64) for g in groups]
        raise ValueError(f"unknown assignment strategy: {strategy}")
    idxs = np.asarray(list(strategy), dtype=np.int64)
    if len(idxs) != n:
        raise ValueError("explicit assignment must name a node per block")
    return [np.nonzero(idxs == k)[0] for k in range(len(nodes))]


def _apply_power_cap(times_tab, energies_tab, ptab, pos, times, energies,
                     group, group_total, group_budget, idle_w,
                     cap_w: float) -> bool:
    """Plan-time Σ-power screen: keep down-clocking until the conservative
    concurrent draw — every node at its own peak-power block, empty nodes at
    idle — fits under ``cap_w``.

    The deadline greedy has already spent the cheap slack; this pass spends
    what remains specifically on the blocks that set each node's power
    peak.  Deterministic: each step targets the highest-peak node whose
    peak block can still step down inside its deadline budget (ties to the
    lower node id, then the lower item id), so a fixed plan always screens
    to the same capped plan.  Mutates ``pos``/``times``/``energies``/
    ``group_total`` in place; returns False when the cap is unreachable
    (some peak is pinned by f_min or an exhausted budget).
    """
    n_groups = len(group_total)
    heaps: list = [[] for _ in range(n_groups)]
    for i in range(len(pos)):
        heaps[group[i]].append((-ptab[i, pos[i]], i))
    for h in heaps:
        heapq.heapify(h)

    def peak(g):
        """(watts, item) at the group's current power peak (-1 when empty).

        Lazy heap: entries priced at a stale ladder position are discarded
        on sight (equal-power staleness is harmless — the watts are right).
        """
        h = heaps[g]
        while h:
            negp, i = h[0]
            if ptab[i, pos[i]] == -negp:
                return -negp, i
            heapq.heappop(h)
        return idle_w[g], -1

    total = sum(peak(g)[0] for g in range(n_groups))
    while total > cap_w + 1e-9:
        best = None  # (peak_w, group, item, dt)
        for g in range(n_groups):
            pk, i = peak(g)
            if i < 0 or pos[i] == 0:
                continue  # empty group, or peak pinned at f_min
            dt = times_tab[i, pos[i] - 1] - times[i]
            if group_total[g] + dt > group_budget[g] + 1e-9:
                continue  # stepping the peak would blow the deadline
            if best is None or pk > best[0]:
                best = (pk, g, i, dt)
        if best is None:
            return False
        _, g, i, dt = best
        pos[i] -= 1
        times[i] = times_tab[i, pos[i]]
        energies[i] = energies_tab[i, pos[i]]
        group_total[g] += dt
        heapq.heappush(heaps[g], (-ptab[i, pos[i]], i))
        total = sum(peak(gg)[0] for gg in range(n_groups))
    return True


def plan_cluster_arrays(
    ba: BlockArrays,
    nodes: Sequence[NodeSpec],
    deadline_s: float,
    *,
    assignment="auto",
    error_margin: float = 0.05,
    power_cap_w: float | None = None,
    calibration=None,
) -> ClusterPlanArrays:
    """``plan_cluster`` over SoA input — the streamed-pipeline entry.

    Accepts the estimates exactly as ``repro.pipeline`` streams them (a
    ``BlockArrays``), never materializes per-block objects, and produces the
    same assignment, frequencies, and energies as the object path (enforced
    by ``tests/test_pipeline.py``).

    ``power_cap_w`` adds a cluster-wide Σ-power feasibility screen after
    the deadline greedy (see ``_apply_power_cap``): the plan's conservative
    concurrent draw must fit under the cap, extra down-clocks are spent on
    peak-power blocks to get there, and ``feasible`` then means *both*
    inside the deadline and under the cap (``power_cap_ok`` carries the
    cap verdict separately).  The runtime engine enforces the same cap
    instant-by-instant at execution (``repro.runtime``).

    ``calibration`` accepts a measured ``repro.calibrate.CounterTrace``:
    every node whose speed/power the trace can identify is upgraded to a
    fitted ``CalibratedNodeSpec`` before planning (see
    ``repro.calibrate.calibrate_nodes``) — the estimate->plan->measure
    loop's re-entry point.
    """
    if not nodes:
        raise ValueError("need at least one node")
    if calibration is not None:
        from repro_torch.calibrate.fit import calibrate_nodes
        nodes = calibrate_nodes(nodes, calibration)
    if isinstance(assignment, str) and assignment == "auto":
        candidates = [plan_cluster_arrays(ba, nodes, deadline_s, assignment=s,
                                          error_margin=error_margin,
                                          power_cap_w=power_cap_w)
                      for s in ("lpt", "pack", "round_robin")]
        feasible = [p for p in candidates if p.feasible]
        if feasible:
            return min(feasible, key=lambda p: p.pred_total_energy)
        return min(candidates, key=lambda p: p.pred_makespan_s)
    budget = deadline_s * (1.0 - error_margin)
    groups = assign_block_arrays(ba, nodes, strategy=assignment,
                                 deadline_s=budget)

    # identical table stacking to plan_cluster, built from array slices
    s_max = max(len(nd.ladder.states) for nd in nodes)
    n_items = sum(len(g) for g in groups)
    times_tab = np.full((n_items, s_max), np.inf)
    energies_tab = np.full((n_items, s_max), np.inf)
    ptab = np.full((n_items, s_max), np.inf) if power_cap_w is not None \
        else None
    pos = np.empty(n_items, dtype=np.int64)
    times = np.empty(n_items)
    energies = np.empty(n_items)
    group = np.empty(n_items, dtype=np.int64)
    group_total = np.zeros(len(nodes))
    lo = 0
    subsets = []
    for k, (nd, g) in enumerate(zip(nodes, groups)):
        sub = ba.select(g)
        subsets.append(sub)
        hi = lo + len(g)
        states = nd.ladder.states
        tab = block_time_table_arrays(sub, states) / nd.speed
        times_tab[lo:hi, :len(states)] = tab
        energies_tab[lo:hi, :len(states)] = busy_energy_table(
            tab, sub.util, states, nd.power)
        if ptab is not None:
            # P(util, f) per (block, state) — the same ptab busy_energy_table
            # folds into energies (energy = time * ptab)
            fpow = np.array([float(np.clip(f, 0.0, 1.0)) ** nd.power.alpha
                             for f in states])
            util = np.clip(sub.util, 0.0, 1.0)
            ptab[lo:hi, :len(states)] = nd.power.p_idle + \
                (nd.power.p_full - nd.power.p_idle) * util[:, None] * fpow[None, :]
        t1 = block_time_table_arrays(sub, (1.0,))[:, 0] / nd.speed
        times[lo:hi] = t1
        energies[lo:hi] = busy_energy_table(t1[:, None], sub.util, (1.0,),
                                            nd.power)[:, 0]
        pos[lo:hi] = len(states) - 1
        group[lo:hi] = k
        group_total[k] = sum(t1.tolist())
        lo = hi

    group_budget = np.full(len(nodes), budget)
    _run_downclock_tables(times_tab, energies_tab, pos, times, energies,
                          group, group_total, group_budget)

    cap_ok = True
    if power_cap_w is not None:
        cap_ok = _apply_power_cap(
            times_tab, energies_tab, ptab, pos, times, energies, group,
            group_total, group_budget,
            [nd.power.p_idle for nd in nodes], power_cap_w)

    node_plans = []
    lo = 0
    for k, (nd, sub) in enumerate(zip(nodes, subsets)):
        hi = lo + len(sub)
        slot = deadline_s / max(len(sub), 1)
        states_arr = np.asarray(nd.ladder.states, dtype=np.float64)
        pa = PlanArrays("cluster", deadline_s, slot, sub.index,
                        states_arr[pos[lo:hi]], times[lo:hi].copy(),
                        energies[lo:hi].copy(),
                        bool(group_total[k] <= deadline_s + 1e-9))
        node_plans.append(NodePlanArrays(nd, pa))
        lo = hi
    feasible = all(t <= deadline_s + 1e-9 for t in group_total.tolist()) \
        and cap_ok
    return ClusterPlanArrays("cluster", deadline_s, tuple(node_plans),
                             feasible, cap_ok)


def plan_cluster(
    blocks: Sequence[BlockInfo] | BlockArrays,
    nodes: Sequence[NodeSpec],
    deadline_s: float,
    *,
    assignment="auto",
    error_margin: float = 0.05,
    power_cap_w: float | None = None,
    calibration=None,
) -> "ClusterPlan | ClusterPlanArrays":
    """Assign blocks to nodes and greedily down-clock across the cluster.

    ``assignment="auto"`` plans every candidate strategy (``lpt``, ``pack``,
    ``round_robin``) and keeps the feasible plan with the lowest predicted
    energy (falling back to the smallest makespan when none is feasible) —
    deterministic, and by construction never worse than planning on the
    baseline's own round-robin split.

    ``power_cap_w`` screens the plan against a cluster-wide instantaneous
    power cap (see ``plan_cluster_arrays``); ``calibration`` accepts a
    measured ``repro.calibrate.CounterTrace`` and plans against fitted
    ``CalibratedNodeSpec``s instead of the constructed constants.

    SoA path: passing a ``BlockArrays`` (e.g. estimates streamed by
    ``repro.pipeline``) returns a ``ClusterPlanArrays`` instead — same
    plans, zero per-block Python objects.
    """
    if isinstance(blocks, BlockArrays):
        return plan_cluster_arrays(blocks, nodes, deadline_s,
                                   assignment=assignment,
                                   error_margin=error_margin,
                                   power_cap_w=power_cap_w,
                                   calibration=calibration)
    # the object path IS the SoA path (same assignment, same stacked tables,
    # same greedy) — a thin wrapper, so the two cannot diverge
    return plan_cluster_arrays(BlockArrays.from_blocks(blocks), nodes,
                               deadline_s, assignment=assignment,
                               error_margin=error_margin,
                               power_cap_w=power_cap_w,
                               calibration=calibration).to_cluster_plan()


def plan_cluster_reference(
    blocks: Sequence[BlockInfo],
    nodes: Sequence[NodeSpec],
    deadline_s: float,
    *,
    assignment="auto",
    error_margin: float = 0.05,
) -> ClusterPlan:
    """Original loop-bound ``plan_cluster`` (equivalence oracle — do not use
    in hot paths; see ``repro.core._reference``)."""
    from repro_torch.core._reference import run_downclock_heap_loops
    if not nodes:
        raise ValueError("need at least one node")
    if isinstance(assignment, str) and assignment == "auto":
        candidates = [plan_cluster_reference(blocks, nodes, deadline_s,
                                             assignment=s,
                                             error_margin=error_margin)
                      for s in ("lpt", "pack", "round_robin")]
        feasible = [p for p in candidates if p.feasible]
        if feasible:
            return min(feasible, key=lambda p: p.pred_total_energy)
        return min(candidates, key=lambda p: p.pred_makespan_s)
    budget = deadline_s * (1.0 - error_margin)
    groups = assign_blocks(blocks, nodes, strategy=assignment,
                           deadline_s=budget)

    items = [(k, j) for k in range(len(nodes))
             for j in range(len(groups[k]))]
    pos = [len(nodes[k].ladder.states) - 1 for k, _ in items]
    times = [nodes[k].block_time(groups[k][j], 1.0) for k, j in items]
    energies = [nodes[k].block_energy(groups[k][j], t, 1.0)
                for (k, j), t in zip(items, times)]
    node_t = [sum(nodes[k].block_time(b, 1.0) for b in grp)
              for k, grp in enumerate(groups)]

    def on_step(i: int, dt: float) -> None:
        node_t[items[i][0]] += dt

    run_downclock_heap_loops(
        len(items),
        lambda i: nodes[items[i][0]].ladder.states,
        lambda i, f: nodes[items[i][0]].block_time(
            groups[items[i][0]][items[i][1]], f),
        lambda i, t, f: nodes[items[i][0]].block_energy(
            groups[items[i][0]][items[i][1]], t, f),
        pos, times, energies,
        step_ok=lambda i, dt: node_t[items[i][0]] + dt <= budget + 1e-9,
        on_step=on_step,
    )

    node_plans = []
    for k, (n, grp) in enumerate(zip(nodes, groups)):
        slot = deadline_s / max(len(grp), 1)
        offset = items.index((k, 0)) if grp else 0
        bps = tuple(BlockPlan(b.index, slot,
                              n.ladder.states[pos[offset + j]],
                              times[offset + j], energies[offset + j])
                    for j, b in enumerate(grp))
        node_plans.append(NodePlan(n, bps))
    feasible = all(t <= deadline_s + 1e-9 for t in node_t)
    return ClusterPlan("cluster", deadline_s, tuple(node_plans), feasible)


def plan_independent(
    blocks: Sequence[BlockInfo],
    nodes: Sequence[NodeSpec],
    deadline_s: float,
    *,
    assignment="round_robin",
    error_margin: float = 0.05,
) -> ClusterPlan:
    """Baseline: per-node independent Algorithm 1 on an oblivious split.

    Each node receives its round-robin share, rescales the estimates to its
    own speed, and runs the paper planner in isolation — no cross-node slack
    trading, equal-count (not equal-work) placement.
    """
    groups = assign_blocks(blocks, nodes, strategy=assignment)
    node_plans = []
    feasible = True
    for n, grp in zip(nodes, groups):
        local = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax / n.speed)
                 for b in grp]
        plan = plan_dvfs(local, deadline_s, planner="paper", ladder=n.ladder,
                         power=n.power, error_margin=error_margin)
        node_plans.append(NodePlan(n, plan.blocks))
        feasible = feasible and plan.feasible
    return ClusterPlan("independent", deadline_s, tuple(node_plans), feasible)
