"""Cross-node block migration — when clocking up to f_max cannot recover.

The online re-planner's only lever is frequency: a straggler node clocks its
tail up to f_max and hopes.  When even f_max misses the deadline (severe
slowdown, tight budget), the work itself has to move.  DV-ARPA's variety
argument applies unchanged: block cost skew is *data*, so the recovery is a
data re-placement, not a re-clock.

Policy (deterministic, SoA-native):

  trigger   the engine invokes ``plan_moves`` at a straggler's telemetry
            event whenever the controller predicts a miss even at f_max
            (``OnlineReplanner.predicted_miss``).  The straggler has just
            finished a block, so *everything* in its queue is queued, never
            in-flight; targets only receive appended work, so their
            in-flight heads are untouched either.

  what      queued blocks in LPT order — ``np.lexsort((index, -base_est))``,
            literally the keys ``assign_block_arrays`` sorts by — largest
            first, ties to the lower block index.

  where     the node with the most predicted slack (deadline minus its
            drift-corrected predicted finish), ties to the lower node id.
            A move is taken only if the target *stays* feasible with the
            block priced at the target's f_max and drift — a previously
            feasible node can never be pushed over its deadline (invariant
            (c) of ``tests/test_runtime.py``).

  then      moves repeat until the straggler's f_max prediction fits (or
            nothing movable helps); one final tail re-plan lets the
            straggler spread whatever slack the moves bought.

Copied from ``src/repro/runtime/migrate.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MigrationModel", "MigrationRecord", "plan_moves"]


@dataclasses.dataclass(frozen=True)
class MigrationModel:
    """What moving one queued block between nodes costs.

    ``latency_s_per_block`` is the transfer latency: a moved block cannot
    START on its destination until ``move time + latency`` (the engine
    defers its launch), and ``plan_moves`` weighs the same latency in its
    gain test — a destination only accepts a block if it stays inside the
    deadline with the block arriving late.

    ``energy_j_per_record`` is the data-size-aware transfer energy: moving
    a block of ``r`` records costs ``r * energy_j_per_record`` joules,
    charged to the SOURCE node's migration ledger at move time.  With
    ``latency_s_per_block > 0`` the same energy is drawn as wire power
    (``energy / latency`` watts) on the source for the transfer window, so
    the cluster power cap sees the transfer; with zero latency the energy
    is charged instantaneously (no draw to meter).  Block sizes come from
    ``BlockInfo.records`` / ``BlockArrays.records`` — blocks without a
    recorded size transfer for free (size unknown, nothing to price).

    The all-zero default keeps moves free, bit-compatible with the
    pre-model behaviour.
    """

    latency_s_per_block: float = 0.0
    energy_j_per_record: float = 0.0

    def __post_init__(self):
        if self.latency_s_per_block < 0:
            raise ValueError("migration latency must be >= 0")
        if self.energy_j_per_record < 0:
            raise ValueError("migration transfer energy must be >= 0")

    def transfer_energy(self, records: float) -> float:
        """Joules to move one block of ``records`` records."""
        return float(records) * self.energy_j_per_record

    def wire_power(self, records: float) -> float:
        """Watts the transfer draws on the wire (0 when instantaneous)."""
        if self.latency_s_per_block <= 0:
            return 0.0
        return self.transfer_energy(records) / self.latency_s_per_block


@dataclasses.dataclass(frozen=True)
class MigrationRecord:
    """One applied move (engine stamps the event time)."""

    time: float
    block_index: int
    src: str
    dst: str
    src_pred_fmax_s: float   # straggler's f_max prediction BEFORE the move
    dst_pred_s: float        # target's predicted finish AFTER the move
    ready_s: float = 0.0     # earliest start on dst (time + transfer latency)
    energy_j: float = 0.0    # transfer energy charged to the source's wire


def plan_moves(controller, straggler: str, now: float,
               *, margin: float = 0.0, max_moves: int | None = None,
               migration: "MigrationModel | None" = None,
               wire_budget_w: float | None = None) -> list:
    """Apply migration moves on ``controller`` state; returns the records.

    Mutates the controller's queues via ``move_blocks`` and finishes with
    one ``replan_node`` on the straggler when anything moved.  ``margin``
    reserves a fraction of the deadline on the STRAGGLER's stop test only —
    its drift EWMA converges from below during a slowdown, so a zero-margin
    prediction flatters it exactly when the decision matters.  The target
    guard compares against the raw deadline: targets are priced at their
    own (converged) drift, and a reserve there would refuse recoveries a
    tight deadline still allows.  ``migration`` charges the transfer cost
    in the gain test: a moved block cannot start on its target before
    ``now + latency``, so a target whose queue would drain before the
    block arrives pays the gap — moves that only fit when free are
    refused.  ``wire_budget_w`` is the cap headroom available for transfer
    draw (the engine passes ``PowerLedger.headroom_w()``): every accepted
    move's wire watts accumulate against it, and a move whose transfer the
    cap cannot power is refused — the target guard sees the wire, not just
    the destination's deadline.  Deterministic: block order is the LPT key sort, target order
    is (slack desc, node id asc), and every quantity read is controller
    state — no clocks, no RNG.
    """
    names = controller.node_names()
    latency = migration.latency_s_per_block if migration is not None else 0.0
    budget = controller.deadline_s * (1.0 - margin)
    dst_budget = controller.deadline_s
    if not controller.predicted_miss(straggler, margin=margin):
        return []
    idx, _ = controller.queued_arrays(straggler)
    if len(idx) == 0:
        return []
    est = controller.base_est_many(idx)
    order = np.lexsort((idx, -est))  # assign_block_arrays' LPT keys

    # one O(queue) pass with incrementally maintained predictions: targets'
    # predicted finishes only GROW as moves land and the straggler's only
    # shrinks, so a block that fits no target now never fits later — the
    # single largest-first sweep decides exactly what the move-at-a-time
    # loop would, at a scan apiece instead of a scan per move
    src_pred = controller.predicted_finish(straggler, at_fmax=True)
    # a target's prediction is busy-time based (elapsed + queued); a node
    # that drained and idled reports a finish in the past, but migrated
    # work cannot start before NOW — clamp, or a late trigger would pass
    # the guard on wall-clock-stale slack and push a previously-feasible
    # node past the deadline.  Down (crashed) nodes take no work.
    pred = {nm: max(controller.predicted_finish(nm), now)
            for nm in names if nm != straggler and controller.node_up(nm)}
    node_id = {nm: k for k, nm in enumerate(names)}
    moves: list = []
    wire_w = 0.0   # accepted moves' cumulative transfer draw this trigger
    for p in order.tolist():
        if src_pred <= budget + 1e-9:
            break
        if max_moves is not None and len(moves) >= max_moves:
            break
        bidx = int(idx[p])
        energy = w = 0.0
        if migration is not None and migration.energy_j_per_record > 0:
            rec = controller.base_records(bidx)
            energy = migration.transfer_energy(rec)
            w = migration.wire_power(rec)
        # cap guard: the transfer itself draws energy/latency watts on the
        # wire for the whole transfer window; a move the cap cannot power
        # is refused outright (no target can make its wire cheaper)
        if wire_budget_w is not None and w > 0 \
                and wire_w + w > wire_budget_w + 1e-9:
            continue
        # targets: most predicted slack first, ties to the lower node id
        for nm in sorted(pred, key=lambda nm: (pred[nm], node_id[nm])):
            # invariant guard: the target must stay inside the deadline
            # with the block priced at ITS f_max under ITS drift, AND the
            # block arriving no earlier than now + transfer latency (a
            # drained target waits for the wire, it cannot time-travel)
            t_add = controller.predicted_block_time(nm, bidx)
            arrival = max(pred[nm], now + latency)
            if arrival + t_add <= dst_budget + 1e-9:
                pred[nm] = arrival + t_add
                wire_w += w
                moves.append(MigrationRecord(now, bidx, straggler,
                                             nm, src_pred, pred[nm],
                                             ready_s=now + latency,
                                             energy_j=energy))
                src_pred -= controller.predicted_block_time(straggler,
                                                            bidx)
                break
    if moves:
        controller.move_blocks(straggler,
                               [(mv.block_index, mv.dst) for mv in moves])
        controller.replan_node(straggler)
    return moves
