"""Crash recovery: checkpoint salvage + a bounded energy-aware retry ladder.

When a node crashes (``repro_torch.runtime.failures``), its in-flight block is
lost back to record granularity and its queued blocks are orphaned.  The
recovery policy decides what happens next — an *energy* decision, in
DV-DVFS terms: restarting lost work at f_max burns the most joules,
waiting for a repair burns none but risks the deadline, and spreading the
orphans over survivors' slack is the variety-driven middle ground.

The ladder, bounded and deterministic (rungs fall through in order):

  1. wait for repair     transient crash, the repair lands early enough
                         that the node's remaining queue still fits at
                         f_max (margin-reserved), the per-node wait budget
                         (``max_waits``) is not exhausted, and — with
                         triage on — the node is not diagnosed as
                         *degrading* (waiting on dying hardware loses
                         twice).  Blocks stay put; the engine relaunches
                         at ``NODE_UP`` after a dead-time-aware re-plan.
  2. migrate to slack    orphans move to the survivor with the most
                         predicted slack (LPT order, lower-id ties — the
                         ``plan_moves`` keys), target-stays-feasible guard
                         at the target's f_max.
  3. f_max blast         each touched survivor re-plans its grown tail
                         (``replan_node``); a tail that no longer fits
                         plans at f_max — the blast is the re-plan's own
                         infeasible fallback, not a separate mechanism.
  4. graceful degrade    blocks that fit NO survivor are still placed
                         (least-resulting-finish survivor) and reported in
                         ``RecoveryDecision.predicted_missed`` — and, if
                         they indeed miss, in ``RuntimeReport.missed_blocks``.
                         With no survivors at all the blocks stay stranded
                         on the dead node: a transient crash runs them
                         late after repair, a permanent one reports them
                         missed.  Nothing raises.

Recovery transfers are priced like migrations (``MigrationModel``): the
per-record transfer energy is charged to the RECEIVING node's migration
ledger (the crashed source cannot drive the wire — survivors pull the
blocks from replicated storage), and no wire power is drawn, so the power
cap cannot deadlock recovery against a dead node's draw.

``salvage_fraction`` is the checkpoint model's arithmetic: given a killed
in-flight block's segment log, the work fraction completed by the last
checkpoint tick (wall-clock ticks every ``interval_s`` from the block's
launch).  The engine folds it into a per-block *work scale* — the salvaged
fraction never re-runs, wherever the block lands.

Copied from ``src/repro/runtime/recovery.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.runtime.failures import CheckpointModel
from repro_torch.runtime.migrate import MigrationModel, MigrationRecord

__all__ = ["RecoveryPolicy", "RecoveryDecision", "recover_crash",
           "plan_crash_moves", "salvage_fraction"]


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs of the crash-recovery ladder (see module doc).

    checkpoint:  salvage model — None loses in-flight work entirely.
    margin:      deadline fraction reserved by the wait-for-repair test
                 (the drift EWMA flatters stragglers; same rationale as
                 the migration trigger's margin).
    max_waits:   wait-for-repair rungs per node before a crash forces
                 migration (bounds the retry ladder).
    use_triage:  consult the drift-cause classifier
                 (``repro_torch.calibrate.triage``): never wait on — and never
                 evacuate onto — a node diagnosed as *degrading*.
                 Needs ``OnlineReplanner(track_ratios=True)``; the engine
                 switches that on automatically.
    """

    checkpoint: CheckpointModel | None = None
    margin: float = 0.05
    max_waits: int = 1
    use_triage: bool = False

    def __post_init__(self):
        if not 0.0 <= self.margin < 1.0:
            raise ValueError("recovery margin must be in [0, 1)")
        if self.max_waits < 0:
            raise ValueError("max_waits must be >= 0")


@dataclasses.dataclass(frozen=True)
class RecoveryDecision:
    """What one crash resolved to (stamped into ``RuntimeReport.recoveries``).

    action:           "none" (empty queue) | "wait" | "migrate" | "stranded"
    moves:            applied ``MigrationRecord``s (action == "migrate")
    predicted_missed: block indices placed best-effort past the deadline
                      (rung 4) or stranded on a permanently dead node
    stranded:         block indices left on the crashed node (wait / no
                      survivors)
    """

    time: float
    node: str
    flavor: str
    action: str
    repair_at: float | None = None
    moves: tuple = ()
    predicted_missed: tuple = ()
    stranded: tuple = ()
    diagnosis: object | None = None


def salvage_fraction(fl, interval_s: float) -> float:
    """Work fraction of a killed in-flight block saved by checkpointing.

    ``fl`` is the block's ``InFlight`` AFTER the crash closed its open
    segment (``split_at``), so ``seg_log`` holds every executed segment as
    ``(start, dur_s, rel_freq, work_frac, energy_j)``.  Checkpoint ticks
    land every ``interval_s`` wall-clock seconds from the block's launch;
    the fraction completed by the LAST tick at or before the crash is what
    survives.  Piecewise-linear within a segment (work accrues uniformly
    at one frequency), exact at segment boundaries.
    """
    if not fl.seg_log:
        return 0.0
    launch = fl.seg_log[0][0]
    crash = fl.seg_log[-1][0] + fl.seg_log[-1][1]
    k = math.floor((crash - launch) / interval_s)
    if k <= 0:
        return 0.0
    t_k = launch + k * interval_s
    frac = 0.0
    for s0, dur, _f, w, _e in fl.seg_log:
        if t_k >= s0 + dur:
            frac += w
        elif t_k > s0 and dur > 0:
            frac += w * ((t_k - s0) / dur)
            break
        else:
            break
    return min(frac, 1.0)


def recover_crash(controller, node: str, now: float, *, flavor: str,
                  repair_at: float | None, policy: RecoveryPolicy,
                  migration: MigrationModel | None = None,
                  waits_so_far: int = 0) -> RecoveryDecision:
    """Resolve one crash on the controller's state; returns the decision.

    Mutates the controller only on the migrate rung (``move_blocks`` +
    per-destination ``replan_node``).  Deterministic: every quantity read
    is controller state, block order is the LPT key sort, target order is
    (slack asc == most headroom first after sign, node id asc).
    """
    idx, _ = controller.queued_arrays(node)
    queued = tuple(int(i) for i in idx.tolist())
    if not queued:
        return RecoveryDecision(now, node, flavor, "none", repair_at)
    diag = controller.diagnose(node) if policy.use_triage else None
    degrading = diag is not None and diag.cause == "degrading"
    deadline = controller.deadline_s

    # rung 1: wait for the repair when the repaired node can still make it
    if flavor == "transient" and repair_at is not None \
            and waits_so_far < policy.max_waits and not degrading:
        wait_finish = repair_at + controller.queued_time(node, at_fmax=True)
        if wait_finish <= deadline * (1.0 - policy.margin) + 1e-9:
            return RecoveryDecision(now, node, flavor, "wait", repair_at,
                                    stranded=queued, diagnosis=diag)

    survivors = [nm for nm in controller.node_names()
                 if nm != node and controller.node_up(nm)]
    if policy.use_triage and survivors:
        healthy = [nm for nm in survivors
                   if controller.diagnose(nm).cause != "degrading"]
        if healthy:     # avoid dying targets, unless they are all we have
            survivors = healthy
    if not survivors:
        # no one to take the work — degrade gracefully, never raise:
        # a transient crash runs its queue late after repair; a permanent
        # one reports exactly which blocks are lost
        action = "stranded" if flavor == "permanent" else "wait"
        return RecoveryDecision(
            now, node, flavor, action, repair_at,
            predicted_missed=(queued if flavor == "permanent" else ()),
            stranded=queued, diagnosis=diag)
    moves, missed = plan_crash_moves(controller, node, now, survivors,
                                     migration=migration)
    return RecoveryDecision(now, node, flavor, "migrate", repair_at,
                            moves=tuple(moves),
                            predicted_missed=tuple(missed), diagnosis=diag)


def plan_crash_moves(controller, crashed: str, now: float, survivors,
                     *, migration: MigrationModel | None = None):
    """Evacuate every queued block of ``crashed`` onto ``survivors``.

    Returns ``(moves, predicted_missed)``.  Reuses the ``plan_moves``
    policy keys — LPT block order, most-slack target, target-stays-
    feasible at the target's f_max — but moves ALL blocks (the source is
    dead; keeping any is not an option) and therefore needs rung 4: a
    block no target fits lands on the least-resulting-finish survivor and
    is reported predicted-missed instead of refused.  Each touched
    destination re-plans once at the end (rung 3: an infeasible tail
    plans at f_max — the blast — and a feasible one spreads its slack).
    """
    idx, _ = controller.queued_arrays(crashed)
    if len(idx) == 0:
        return [], []
    est = controller.base_est_many(idx)
    order = np.lexsort((idx, -est))     # LPT, ties to the lower block index
    latency = migration.latency_s_per_block if migration is not None else 0.0
    price = migration is not None and migration.energy_j_per_record > 0
    deadline = controller.deadline_s
    src_pred = controller.predicted_finish(crashed, at_fmax=True)
    pred = {nm: max(controller.predicted_finish(nm), now) for nm in survivors}
    node_id = {nm: j for j, nm in enumerate(controller.node_names())}
    moves: list = []
    missed: list = []
    for p in order.tolist():
        bidx = int(idx[p])
        energy = 0.0
        if price:
            energy = migration.transfer_energy(controller.base_records(bidx))
        best = None      # fallback: (resulting finish, node id, name, t_add)
        placed = None
        for nm in sorted(pred, key=lambda nm: (pred[nm], node_id[nm])):
            t_add = controller.predicted_block_time(nm, bidx)
            finish = max(pred[nm], now + latency) + t_add
            if finish <= deadline + 1e-9:
                placed = (nm, finish)
                break
            if best is None or (finish, node_id[nm]) < best[:2]:
                best = (finish, node_id[nm], nm)
        if placed is None:
            # rung 4: nothing fits — land on the least-bad survivor and
            # REPORT the predicted miss instead of raising
            missed.append(bidx)
            placed = (best[2], best[0])
        nm, finish = placed
        pred[nm] = finish
        moves.append(MigrationRecord(now, bidx, crashed, nm,
                                     src_pred_fmax_s=src_pred,
                                     dst_pred_s=finish,
                                     ready_s=now + latency,
                                     energy_j=energy))
    controller.move_blocks(crashed,
                           [(mv.block_index, mv.dst) for mv in moves])
    for nm in sorted({mv.dst for mv in moves},
                     key=lambda nm: node_id[nm]):
        controller.replan_node(nm)      # rung 3 folded in
    return moves, missed
