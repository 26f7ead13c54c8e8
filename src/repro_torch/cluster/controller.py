"""Online feedback re-planning: the paper's offline Algorithm 1, streamed.

The offline plan fixes every frequency before the run.  On a real cluster the
estimates drift (interference, thermal throttling, mis-sampled blocks), so the
controller closes the loop *between blocks*:

  observe      each finished block reports its wall time; the controller
               compares it with the *base* (undrifted) prediction at the
               frequency actually run and feeds the ratio into the same EWMA
               machinery as ``repro.train.straggler.StragglerDetector`` — the
               EWMA mean of observed/predicted IS the node's drift estimate,
               and the z-score/budget logic flags straggler blocks for free.

  re-plan      when a node's drift has moved more than ``replan_threshold``
               (relative) since its last plan, the remaining blocks are
               re-estimated (base estimate × drift), the remaining deadline
               budget is recomputed (deadline − elapsed), and the single-node
               greedy down-clock re-runs on just that node's tail: late nodes
               clock up, early nodes harvest the extra slack.

  hysteresis   re-planning is *relative to the drift at the previous re-plan*,
               not to 1.0 — a node that drifted once and then runs true to its
               corrected estimate never re-plans again, so frequencies cannot
               oscillate between two ladder states on estimation noise.

Copied from ``src/repro/cluster/controller.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scheduler import BlockInfo, BlockPlan, plan_dvfs_arrays
from repro_torch.core.soa import BlockArrays
from repro_torch.cluster.planner import ClusterPlan
from repro_torch.train.straggler import StragglerDetector

__all__ = ["OnlineReplanner"]


class _LazyBase(dict):
    """``index -> BlockInfo`` view over a ``BlockArrays`` base store.

    Materializes (and memoizes) one ``BlockInfo`` per *touched* index —
    the scalar observe/move paths only ever look at the handful of blocks
    they actually process, so a million-block run never pays the full
    ``to_blocks()`` conversion up front.  Reconstruction is field-for-field
    the ``BlockArrays.to_blocks`` idiom, so the floats are the arrays' own.
    """

    def __init__(self, ba: BlockArrays, sorted_idx, order):
        super().__init__()
        self._ba, self._sorted, self._order = ba, sorted_idx, order

    def __missing__(self, index):
        from repro_torch.core.estimator import RooflineTerms, RooflineTimeModel
        j = int(np.searchsorted(self._sorted, index))
        if j >= len(self._sorted) or int(self._sorted[j]) != int(index):
            raise KeyError(index)
        ba, i = self._ba, int(self._order[j])
        roof = None
        if ba.roofline is not None and bool(ba.roofline.has[i]):
            roof = RooflineTimeModel(RooflineTerms(
                t_comp=float(ba.roofline.t_comp[i]),
                t_mem=float(ba.roofline.t_mem[i]),
                t_coll=float(ba.roofline.t_coll[i]),
                t_fixed=float(ba.roofline.t_fixed[i])))
        b = BlockInfo(index=int(ba.index[i]),
                      est_time_fmax=float(ba.est_time_fmax[i]),
                      est_rel_halfwidth=float(ba.est_rel_halfwidth[i]),
                      util=float(ba.util[i]), roofline=roof,
                      records=(float(ba.records[i])
                               if ba.records is not None else 0.0))
        self[index] = b
        return b


class _SoAQueue:
    """Array-backed FIFO of planned blocks: the ``BlockPlan`` columns plus a
    head offset.  A pop advances the offset (O(1), no element shuffle, no
    object churn); restructures (re-plan, migration) swap whole arrays.
    ``head()`` materializes a real ``BlockPlan`` on demand, so the object
    consumers (the engine's launch path, the block-boundary oracle, tests)
    still see the dataclass — with the arrays' own floats."""

    __slots__ = ("idx", "freq", "pred_t", "pred_e", "slot", "off")

    def __init__(self, idx, freq, pred_t, pred_e, slot, off: int = 0):
        self.idx, self.freq = idx, freq
        self.pred_t, self.pred_e, self.slot = pred_t, pred_e, slot
        self.off = off

    @classmethod
    def from_plan_arrays(cls, pa) -> "_SoAQueue":
        return cls(pa.index, pa.rel_freq, pa.pred_time_s, pa.pred_energy_j,
                   np.full(len(pa.index), pa.slot_s))

    @classmethod
    def from_blocks(cls, blocks) -> "_SoAQueue":
        n = len(blocks)
        return cls(
            np.fromiter((b.index for b in blocks), np.int64, count=n),
            np.fromiter((b.rel_freq for b in blocks), np.float64, count=n),
            np.fromiter((b.pred_time_s for b in blocks), np.float64, count=n),
            np.fromiter((b.pred_energy_j for b in blocks), np.float64,
                        count=n),
            np.fromiter((b.slot_s for b in blocks), np.float64, count=n))

    def __len__(self) -> int:
        return len(self.idx) - self.off

    def __bool__(self) -> bool:
        return len(self.idx) > self.off

    def head(self) -> BlockPlan:
        o = self.off
        return BlockPlan(index=int(self.idx[o]), slot_s=float(self.slot[o]),
                         rel_freq=float(self.freq[o]),
                         pred_time_s=float(self.pred_t[o]),
                         pred_energy_j=float(self.pred_e[o]))

    def blocks(self) -> tuple:
        o = self.off
        return tuple(
            BlockPlan(index=int(i), slot_s=float(s), rel_freq=float(f),
                      pred_time_s=float(t), pred_energy_j=float(e))
            for i, s, f, t, e in zip(
                self.idx[o:].tolist(), self.slot[o:].tolist(),
                self.freq[o:].tolist(), self.pred_t[o:].tolist(),
                self.pred_e[o:].tolist()))


@dataclasses.dataclass
class _NodeState:
    spec: object                 # NodeSpec
    queue: _SoAQueue             # remaining planned blocks, head = next to run
    detector: StragglerDetector  # EWMA over observed/predicted ratios
    drift: float = 1.0
    drift_at_replan: float = 1.0
    elapsed_s: float = 0.0
    done: int = 0
    replans: int = 0
    last_feasible: bool = True   # feasibility of the most recent re-plan
    version: int = 0             # bumped on any non-pop queue restructure
    up: bool = True              # crashed nodes take no migrated work
    dead_s: float = 0.0          # outage seconds (shrinks the replan budget)
    ratios: list = dataclasses.field(default_factory=list)  # triage log


class OnlineReplanner:
    """Per-node drift tracking + tail re-planning over a ``ClusterPlan``.

    ``est_blocks`` are the planner's base estimates (the BlockInfo the plan was
    built from); drift is always measured against these, never against an
    already-drift-scaled prediction, so the EWMA converges to the true
    slowdown factor instead of chasing its own corrections.
    """

    def __init__(self, plan: ClusterPlan, est_blocks=None, *,
                 base_arrays: BlockArrays | None = None,
                 replan_threshold: float = 0.15, ewma_alpha: float = 0.3,
                 error_margin: float = 0.05, calibrator=None,
                 track_ratios: bool = False):
        if est_blocks is not None:
            self._ba = BlockArrays.from_blocks(est_blocks)
        elif base_arrays is not None:
            self._ba = base_arrays
        else:
            raise ValueError("OnlineReplanner needs est_blocks or base_arrays")
        self._ba_order = np.argsort(self._ba.index, kind="stable")
        self._ba_sorted = self._ba.index[self._ba_order]
        # contiguous 0..n-1 indices (the SoA build default) make the
        # index->position map the identity
        self._ba_ident = bool(np.array_equal(
            self._ba_sorted, np.arange(len(self._ba_sorted),
                                       dtype=np.int64)))
        # BlockInfo view: eager when the caller already has the objects,
        # lazily materialized from the arrays otherwise (the million-block
        # seeding path — the scalar observe/move code touches few blocks)
        self._base = ({b.index: b for b in est_blocks}
                      if est_blocks is not None
                      else _LazyBase(self._ba, self._ba_sorted,
                                     self._ba_order))
        self.deadline_s = plan.deadline_s
        self.replan_threshold = replan_threshold
        self.error_margin = error_margin
        self.ewma_alpha = ewma_alpha
        self.calibrator = calibrator   # repro.calibrate.OnlineCalibrator
        self.track_ratios = track_ratios  # keep per-block ratios for triage
        # per-block remaining-work scale, SHARED with the engine
        # (attach_work_scale): a crash-salvaged block re-runs only its
        # un-checkpointed remainder, so every prediction must shrink with it
        self._wscale: dict = {}
        self.replan_log: list = []
        self.recalibrations: list = []
        self._nodes: dict = {}
        for np_ in plan.node_plans:
            det = StragglerDetector(alpha=ewma_alpha, warmup_steps=2)
            # ClusterPlan carries NodePlan (materialized BlockPlans);
            # ClusterPlanArrays carries NodePlanArrays (PlanArrays) — both
            # seed the same SoA queue, the latter without materializing a
            # single per-block object
            q = (_SoAQueue.from_blocks(np_.blocks)
                 if hasattr(np_, "blocks")
                 else _SoAQueue.from_plan_arrays(np_.plan))
            self._nodes[np_.node.name] = _NodeState(
                spec=np_.node, queue=q, detector=det)

    # --- execution interface -------------------------------------------------
    def next_block(self, node_name: str):
        """The BlockPlan this node should run next (None when drained)."""
        q = self._nodes[node_name].queue
        return q.head() if q else None

    def next_block_brief(self, node_name: str):
        """``(index, rel_freq)`` of the next block — the launch path's view,
        without materializing a ``BlockPlan``.  None when drained."""
        q = self._nodes[node_name].queue
        if not q:
            return None
        return int(q.idx[q.off]), float(q.freq[q.off])

    def observe(self, node_name: str, observed_s: float) -> bool:
        """Record the head block's wall time; returns True if we re-planned."""
        st = self._record(node_name, observed_s)
        rel_change = abs(st.drift / st.drift_at_replan - 1.0)
        if st.queue and rel_change > self.replan_threshold:
            self._replan_node(node_name, st)
            return True
        return False

    def _record(self, node_name: str, observed_s: float) -> _NodeState:
        """Pop the head block, advance elapsed time, update the drift EWMA —
        the observation WITHOUT the replan decision."""
        st = self._nodes[node_name]
        q = st.queue
        b_index, b_freq = int(q.idx[q.off]), float(q.freq[q.off])
        q.off += 1
        st.elapsed_s += observed_s
        st.done += 1
        base_pred = st.spec.block_time(self._base[b_index], b_freq)
        if self._wscale:
            s = self._wscale.get(b_index)
            if s is not None:   # salvaged block: only the remainder ran
                base_pred = base_pred * s
        ratio = observed_s / max(base_pred, 1e-12)
        # ratio stream through the straggler EWMA: mean == drift estimate,
        # planned_slot_s=1.0 makes "late vs budget" mean "ratio >> 1"
        st.detector.observe(st.done, ratio, planned_slot_s=1.0)
        st.drift = max(st.detector.mean, 1e-6)
        if self.track_ratios:
            st.ratios.append((st.done, ratio))
        return st

    def on_telemetry(self, node_name: str, observed_s: float,
                     samples=()) -> bool:
        """Event-driven entry for the runtime engine (``repro.runtime``).

        A ``TELEMETRY`` event carries a finished block's wall time; this is
        the same observation ``observe`` consumes in the block-boundary
        loop, delivered through the event queue instead of a per-block
        callback.  ``samples`` optionally carries the block's counter-trace
        segments (``repro.calibrate.CounterSample``, one per executed
        frequency segment); with a calibrator attached they feed the
        windowed refit, and a model change re-plans the node's tail against
        the RECALIBRATED spec.  Returns True when the observation triggered
        a re-plan (drift- or calibration-driven).
        """
        changed = False
        if self.calibrator is not None and samples:
            for s in samples:
                changed = self.calibrator.add(s) or changed
        if not changed:
            return self.observe(node_name, observed_s)
        # a calibration change supersedes the drift test: record the
        # observation without observe()'s replan (its plan against the
        # stale spec would be thrown away one line later), then re-plan
        # once against the recalibrated spec
        self._record(node_name, observed_s)
        self._apply_calibration(node_name)
        return True

    def _apply_calibration(self, node_name: str) -> None:
        """Swap the node's spec for the calibrator's current fit and re-plan.

        The fitted speed already absorbs the slowdown the drift EWMA was
        tracking (both are fitted on the same observed walls against the
        same base estimates), so drift resets to 1.0 — leaving it in place
        would apply the correction twice.  The detector restarts so the
        fresh EWMA tracks residual drift against the NEW spec.
        """
        st = self._nodes[node_name]
        st.spec = self.calibrator.calibrated_spec(node_name, st.spec)
        st.detector = StragglerDetector(alpha=self.ewma_alpha,
                                        warmup_steps=2)
        st.drift = 1.0
        st.drift_at_replan = 1.0
        st.version += 1   # belief spec changed: queue-derived caches stale
        self.recalibrations.append({
            "node": node_name, "after_block": st.done,
            "speed": st.spec.speed,
            "power": (st.spec.power.p_idle, st.spec.power.p_full,
                      st.spec.power.alpha)})
        if st.queue:
            self._replan_node(node_name, st)

    @property
    def total_replans(self) -> int:
        return sum(st.replans for st in self._nodes.values())

    def straggler_events(self, node_name: str) -> list:
        return self._nodes[node_name].detector.events

    # --- state the runtime's migration policy reads/edits --------------------
    def base_est(self, index: int) -> float:
        """The planner's base (undrifted) f_max estimate for one block."""
        return self._base[index].est_time_fmax

    def base_records(self, index: int) -> float:
        """The block's data size (records; 0 when the estimate carries
        none) — what the migration wire model prices transfers by."""
        return self._base[index].records

    def node_names(self) -> tuple:
        return tuple(self._nodes)

    def drift_of(self, node_name: str) -> float:
        return self._nodes[node_name].drift

    def queued(self, node_name: str) -> tuple:
        """The node's remaining BlockPlans (head first), as a copy."""
        return self._nodes[node_name].queue.blocks()

    def queue_depths(self) -> dict:
        """Remaining queued blocks per node, ``{name: count}`` in node
        order — the observability layer's queue-depth gauge seed."""
        return {name: len(ns.queue) for name, ns in self._nodes.items()}

    def node_feasible(self, node_name: str) -> bool:
        """Did the node's most recent re-plan fit its remaining budget?"""
        return self._nodes[node_name].last_feasible

    # --- state the runtime's failure/recovery machinery reads/edits ----------
    def set_node_up(self, node_name: str, up: bool) -> None:
        """Crash/repair bookkeeping: down nodes take no migrated work."""
        self._nodes[node_name].up = up

    def node_up(self, node_name: str) -> bool:
        return self._nodes[node_name].up

    def add_dead_time(self, node_name: str, seconds: float) -> None:
        """Charge an outage against the node's remaining deadline budget:
        ``elapsed_s`` tracks busy seconds only, so without this a repaired
        node would re-plan against wall-clock budget it no longer has."""
        self._nodes[node_name].dead_s += seconds

    def touch(self, node_name: str) -> None:
        """Bump the node's queue version WITHOUT restructuring it — anything
        cached against ``queue_state`` (the vectorized engine's priced
        queues) must rebuild after a crash re-scales or freezes the queue."""
        self._nodes[node_name].version += 1

    def attach_work_scale(self, scale: dict) -> None:
        """Share the engine's per-block remaining-work scale (index ->
        fraction).  The SAME dict object — checkpoint salvage updates land
        in both at once.  Empty dict == no crash ever salvaged anything,
        and every scale path below stays bitwise untouched."""
        self._wscale = scale

    def _scale_arr(self, idx) -> np.ndarray:
        ws = self._wscale
        return np.fromiter((ws.get(int(i), 1.0) for i in idx.tolist()),
                           np.float64, count=len(idx))

    def diagnose(self, node_name: str):
        """Drift-cause triage over the node's observed/predicted ratio log
        (``repro.calibrate.triage``).  Needs ``track_ratios=True``; with an
        empty log the diagnosis is ``"none"`` (insufficient evidence)."""
        from repro_torch.calibrate.triage import classify_ratios
        st = self._nodes[node_name]
        return classify_ratios([r for _, r in st.ratios])

    def _pos_of(self, idx):
        """Base-array positions for an array of global block indices."""
        if self._ba_ident:
            return idx
        return self._ba_order[np.searchsorted(self._ba_sorted, idx)]

    def _vec_block_time(self, spec, pos, freq):
        """``NodeSpec.block_time`` over base-array positions, op for op
        (``freq`` may be a scalar or a per-element array)."""
        est = self._ba.est_time_fmax[pos]
        fv = np.maximum(freq, 1e-6)
        roof = self._ba.roofline
        if roof is not None:
            tc, tm = roof.t_comp[pos], roof.t_mem[pos]
            tl, tf = roof.t_coll[pos], roof.t_fixed[pos]
            at_f = np.maximum(np.maximum(tc / fv, tm), tl) + tf
            at_1 = np.maximum(np.maximum(tc / 1.0, tm), tl) + tf
            base = np.where(roof.has[pos],
                            at_f * (est / np.maximum(at_1, 1e-12)), est / fv)
        else:
            base = est / fv
        return base / spec.speed

    def base_est_many(self, idx) -> np.ndarray:
        """``base_est`` over an index array (same floats, no objects)."""
        return self._ba.est_time_fmax[self._pos_of(idx)]

    def base_records_many(self, idx) -> np.ndarray:
        """``base_records`` over an index array (zeros when sizes unknown)."""
        if self._ba.records is None:
            return np.zeros(len(idx))
        return self._ba.records[self._pos_of(idx)]

    def predicted_finish(self, node_name: str, *, at_fmax: bool = False
                         ) -> float:
        """Elapsed + drift-corrected predicted time of the remaining queue.

        ``at_fmax`` prices every queued block at the node's f_max instead of
        its planned frequency — the "is this node recoverable by clocking up
        alone?" question the migration trigger asks.  The sequential
        ``total += t * drift`` chain is reproduced with ``np.cumsum`` over
        the queue arrays — bitwise the same sum, one pass instead of a
        Python loop per block.
        """
        st = self._nodes[node_name]
        elapsed = st.elapsed_s + st.dead_s if st.dead_s else st.elapsed_s
        if not st.queue:
            return elapsed
        idx, freq = self.queued_arrays(node_name)
        f = st.spec.ladder.f_max if at_fmax else freq
        terms = self._vec_block_time(st.spec, self._pos_of(idx), f)
        if self._wscale:
            terms = terms * self._scale_arr(idx)
        terms = terms * st.drift
        return float(np.cumsum(np.concatenate(([elapsed], terms)))[-1])

    def queued_time(self, node_name: str, *, at_fmax: bool = False) -> float:
        """Predicted seconds of the remaining queue ALONE (no elapsed seed)
        — what a wait-for-repair decision adds to the repair time."""
        st = self._nodes[node_name]
        if not st.queue:
            return 0.0
        idx, freq = self.queued_arrays(node_name)
        f = st.spec.ladder.f_max if at_fmax else freq
        terms = self._vec_block_time(st.spec, self._pos_of(idx), f)
        if self._wscale:
            terms = terms * self._scale_arr(idx)
        return float(np.cumsum(terms * st.drift)[-1])

    def predicted_block_time(self, node_name: str, index: int,
                             rel_freq: float | None = None) -> float:
        """Drift-corrected predicted time of one block on ``node_name``
        (at the node's f_max unless ``rel_freq`` is given)."""
        st = self._nodes[node_name]
        f = st.spec.ladder.f_max if rel_freq is None else rel_freq
        t = st.spec.block_time(self._base[index], f)
        if self._wscale:
            s = self._wscale.get(index)
            if s is not None:
                t = t * s
        return t * st.drift

    def predicted_miss(self, node_name: str, *, margin: float = 0.0) -> bool:
        """True when the node misses the deadline even at f_max everywhere.

        ``margin`` reserves a fraction of the deadline (Algorithm 1's
        reserved area): the drift EWMA converges from below during a
        slowdown, so a zero-margin prediction systematically flatters the
        straggler right when the decision matters.
        """
        return self.predicted_finish(node_name, at_fmax=True) \
            > self.deadline_s * (1.0 - margin) + 1e-9

    def on_alert(self, alert) -> int:
        """Watchdog hook: a firing deadline-risk alert forces an immediate
        tail re-plan of every up node with queued work that is predicted
        to miss — the existing replan machinery, triggered by the burn
        rate instead of waiting for the EWMA drift threshold.  Returns the
        number of nodes re-planned.  Alerts on other signals are ignored
        (energy/cap pressure has no replan lever here).
        """
        if getattr(alert, "signal", "deadline_risk") != "deadline_risk":
            return 0
        n = 0
        for name, st in self._nodes.items():
            if st.up and st.queue and self.predicted_miss(name):
                self._replan_node(name, st)
                n += 1
        return n

    def move_block(self, src: str, dst: str, block_index: int) -> None:
        """Move one QUEUED block from ``src``'s queue to the tail of ``dst``.

        The block re-enters at the destination's f_max (safe under the
        migration feasibility guard); the destination's own later re-plans
        spread its slack across the grown tail.  Appending never touches
        ``dst``'s queue head, so an in-flight block is never re-planned or
        moved by migration.
        """
        self.move_blocks(src, [(block_index, dst)])

    def move_blocks(self, src: str, moves) -> None:
        """Bulk ``move_block``: ``moves`` is ``[(block_index, dst), ...]``.

        One pass over the source queue regardless of the move count — the
        migration policy applies a whole batch at once instead of paying a
        queue scan per block.
        """
        s = self._nodes[src]
        dst_of = {int(i): d for i, d in moves}
        if len(dst_of) != len(moves):
            raise ValueError("duplicate block index in migration batch")
        q = s.queue
        o = q.off
        idx_l = q.idx[o:]
        moved = np.isin(idx_l, np.fromiter(dst_of, np.int64,
                                           count=len(dst_of)))
        # group moved blocks per destination IN SOURCE-QUEUE ORDER (the
        # order the per-block loop appended them in)
        pend: dict = {}
        for p in np.flatnonzero(moved).tolist():
            bidx = int(idx_l[p])
            pend.setdefault(dst_of.pop(bidx), []).append(p)
        if dst_of:
            raise KeyError(f"blocks {sorted(dst_of)} not queued on {src}")
        for dst, ps in pend.items():
            d = self._nodes[dst]
            f = d.spec.ladder.f_max
            add_t, add_e = [], []
            for p in ps:
                bidx = int(idx_l[p])
                base = self._base[bidx]
                t = d.spec.block_time(base, f)
                if self._wscale:
                    sc = self._wscale.get(bidx)
                    if sc is not None:
                        t = t * sc
                add_t.append(t)
                add_e.append(d.spec.block_energy(base, t, f))
            dq, m = d.queue, len(ps)
            do = dq.off
            d.queue = _SoAQueue(
                np.concatenate((dq.idx[do:], idx_l[ps])),
                np.concatenate((dq.freq[do:], np.full(m, f))),
                np.concatenate((dq.pred_t[do:], np.asarray(add_t))),
                np.concatenate((dq.pred_e[do:], np.asarray(add_e))),
                np.concatenate((dq.slot[do:], q.slot[o:][ps])))
            d.version += 1
        keep = ~moved
        s.queue = _SoAQueue(idx_l[keep], q.freq[o:][keep], q.pred_t[o:][keep],
                            q.pred_e[o:][keep], q.slot[o:][keep])
        s.version += 1

    # --- open-loop serving interface (repro.serving) -------------------------
    def set_horizon(self, deadline_s: float) -> None:
        """Move the planning horizon (rolling-horizon serving: the horizon
        follows the latest admitted job deadline).  Only affects FUTURE
        re-plans and miss predictions — nothing already queued is touched,
        so closed-batch runs that never call this are bitwise unchanged."""
        if not deadline_s > 0:
            raise ValueError("horizon must be positive")
        self.deadline_s = float(deadline_s)

    def extend_base(self, extra: BlockArrays) -> None:
        """Append arrived blocks to the base-estimate store.

        Pre-existing blocks keep their exact floats (``BlockArrays.concat``
        copies; positions re-derive from a stable argsort), so drift ratios
        and re-plans for already-planned work are unchanged bitwise.
        """
        if np.isin(extra.index, self._ba_sorted).any():
            raise ValueError("arrived block indices collide with the base "
                             "store")
        self._ba = BlockArrays.concat(self._ba, extra)
        self._ba_order = np.argsort(self._ba.index, kind="stable")
        self._ba_sorted = self._ba.index[self._ba_order]
        self._ba_ident = bool(np.array_equal(
            self._ba_sorted, np.arange(len(self._ba_sorted),
                                       dtype=np.int64)))
        if isinstance(self._base, _LazyBase):
            # fresh lazy view over the extended arrays: memoized entries are
            # rebuilt on demand with the arrays' own floats
            self._base = _LazyBase(self._ba, self._ba_sorted, self._ba_order)
        else:
            for b in extra.to_blocks():
                self._base[b.index] = b

    def append_blocks(self, node_name: str, indices) -> None:
        """Append admitted blocks (already in the base store via
        ``extend_base``) to the tail of ``node_name``'s queue, each priced
        at the node's f_max — the same entry pricing a migrated block gets;
        the node's own later re-plans spread slack across the grown tail."""
        d = self._nodes[node_name]
        f = d.spec.ladder.f_max
        add_t, add_e = [], []
        for bidx in indices:
            base = self._base[int(bidx)]
            t = d.spec.block_time(base, f)
            if self._wscale:
                sc = self._wscale.get(int(bidx))
                if sc is not None:
                    t = t * sc
            add_t.append(t)
            add_e.append(d.spec.block_energy(base, t, f))
        dq, m = d.queue, len(add_t)
        do = dq.off
        d.queue = _SoAQueue(
            np.concatenate((dq.idx[do:],
                            np.fromiter((int(i) for i in indices), np.int64,
                                        count=m))),
            np.concatenate((dq.freq[do:], np.full(m, f))),
            np.concatenate((dq.pred_t[do:], np.asarray(add_t))),
            np.concatenate((dq.pred_e[do:], np.asarray(add_e))),
            np.concatenate((dq.slot[do:], np.asarray(add_t))))
        d.version += 1

    def drop_blocks(self, node_name: str, indices) -> None:
        """Remove QUEUED blocks from ``node_name`` (SLO-aware shedding).
        The caller must never drop the in-flight head — shed only jobs
        none of whose blocks have started."""
        s = self._nodes[node_name]
        q = s.queue
        o = q.off
        idx_l = q.idx[o:]
        want = np.fromiter((int(i) for i in indices), np.int64,
                           count=len(indices))
        drop = np.isin(idx_l, want)
        if int(drop.sum()) != len(set(want.tolist())):
            missing = sorted(set(want.tolist())
                             - set(idx_l[drop].tolist()))
            raise KeyError(f"blocks {missing} not queued on {node_name}")
        keep = ~drop
        s.queue = _SoAQueue(idx_l[keep], q.freq[o:][keep],
                            q.pred_t[o:][keep], q.pred_e[o:][keep],
                            q.slot[o:][keep])
        s.version += 1

    def queued_pred_times(self, node_name: str) -> np.ndarray:
        """Per-element drift-corrected predicted seconds of the remaining
        queue (the terms ``predicted_finish`` cumsums) — the serving
        fabric's per-job feasibility walk prefixes over these."""
        st = self._nodes[node_name]
        if not st.queue:
            return np.empty(0)
        idx, freq = self.queued_arrays(node_name)
        terms = self._vec_block_time(st.spec, self._pos_of(idx), freq)
        if self._wscale:
            terms = terms * self._scale_arr(idx)
        return terms * st.drift

    def replan_node(self, node_name: str, budget_s: float | None = None,
                    skip_head: bool = False) -> None:
        """Re-run the tail plan for one node (no-op on a drained queue).

        ``budget_s`` overrides the deadline-derived budget (rolling-horizon
        serving plans against wall-clock slack, not ``deadline - elapsed``);
        ``skip_head`` leaves the queue head untouched — the serving fabric
        re-plans behind an IN-FLIGHT block, whose telemetry must still be
        priced at the frequency it launched with.
        """
        st = self._nodes[node_name]
        if st.queue:
            self._replan_node(node_name, st, budget_s=budget_s,
                              skip=1 if skip_head else 0)

    # --- batch interface for the vectorized runtime engine -------------------
    def queue_state(self, node_name: str) -> tuple:
        """``(version, done)`` — the key that identifies the queue's exact
        content: ``version`` bumps on any restructure (re-plan, migration,
        recalibration), ``done`` counts head pops.  Anything derived purely
        from queue content may be cached against this pair and sliced by
        the pop delta."""
        st = self._nodes[node_name]
        return st.version, st.done

    def queued_arrays(self, node_name: str):
        """The node's remaining queue as ``(index, rel_freq)`` arrays —
        the SoA view the vectorized engine prices whole stretches from.
        The queue IS arrays, so this is a pair of O(1) views."""
        q = self._nodes[node_name].queue
        return q.idx[q.off:], q.freq[q.off:]

    def node_spec_of(self, node_name: str):
        """The node's current BELIEF spec (base predictions price off it)."""
        return self._nodes[node_name].spec

    def scan_observations(self, node_name: str, observed_s,
                          base_pred) -> int:
        """How many leading head-of-queue observations the node absorbs
        WITHOUT re-planning — a pure, bitwise-faithful simulation of
        consecutive ``observe`` calls (no state is touched).

        ``observed_s[i]`` / ``base_pred[i]`` describe the node's i-th next
        finish in queue order.  Returns ``k``: observations ``0..k-1``
        leave the drift EWMA inside the hysteresis band; observation ``k``
        (if it exists) would trigger ``_replan_node``.  The vectorized
        engine fast-forwards exactly ``k`` finishes and lets the next one
        run through the scalar path, where the re-plan (and anything it
        cascades into — migration, frequency changes) happens with full
        fidelity.
        """
        st = self._nodes[node_name]
        det = st.detector
        qlen = len(st.queue)
        k = min(len(observed_s), qlen)
        if k == 0:
            return 0
        ratios = np.asarray(observed_s, dtype=np.float64)[:k] \
            / np.maximum(np.asarray(base_pred, dtype=np.float64)[:k], 1e-12)
        thr = self.replan_threshold
        drift_at = st.drift_at_replan
        # quiescent fast path: every ratio equals the settled EWMA mean at
        # zero variance, so the update chain is a bitwise no-op — either
        # the very first observation re-plans or none of them do
        if det.n > 0 and det.var == 0.0 and bool(np.all(ratios == det.mean)):
            drift = max(det.mean, 1e-6)
            if abs(drift / drift_at - 1.0) > thr:
                return 0 if qlen > 1 else k
            return k
        alpha, mean, var, n = det.alpha, det.mean, det.var, det.n
        for i in range(k):
            r = float(ratios[i])
            if n == 0:
                mean = r
            else:
                d = r - mean
                mean += alpha * d
                var = (1 - alpha) * (var + alpha * d * d)
            n += 1
            drift = max(mean, 1e-6)
            if qlen - (i + 1) > 0 and abs(drift / drift_at - 1.0) > thr:
                return i
        return k

    def commit_observations(self, node_name: str, observed_s,
                            base_pred) -> None:
        """Apply a ``scan_observations``-cleared batch of head-of-queue
        observations: bitwise-identical final state to one ``observe`` per
        block (drift EWMA, elapsed chain, straggler events), but the queue
        advances in one slice and the quiescent case never re-walks the
        EWMA floats.  The caller guarantees no observation in the batch
        re-plans (that is exactly what ``scan_observations`` bounds)."""
        st = self._nodes[node_name]
        c = len(observed_s)
        if c == 0:
            return
        if c > len(st.queue):
            raise ValueError("batch longer than the node's queue")
        obs = np.asarray(observed_s, dtype=np.float64)
        ratios = obs / np.maximum(np.asarray(base_pred, dtype=np.float64),
                                  1e-12)
        det = st.detector
        st.queue.off += c
        # += per block is a sequential float chain — cumsum reproduces it
        st.elapsed_s = float(np.cumsum(
            np.concatenate(([st.elapsed_s], obs)))[-1])
        if det.n > 0 and det.var == 0.0 \
                and bool(np.all(ratios == det.mean)) \
                and not det.mean > det.budget_factor:
            det.n += c          # the whole update chain is a bitwise no-op
        else:
            for i, r in enumerate(ratios.tolist()):
                det.observe(st.done + 1 + i, r, planned_slot_s=1.0)
        if self.track_ratios:
            st.ratios.extend(
                (st.done + 1 + i, r) for i, r in enumerate(ratios.tolist()))
        st.done += c
        st.drift = max(det.mean, 1e-6)

    # --- internal ------------------------------------------------------------
    def _replan_node(self, name: str, st: _NodeState,
                     budget_s: float | None = None, skip: int = 0) -> None:
        if budget_s is None:
            budget = self.deadline_s - st.elapsed_s
            if st.dead_s:  # outage seconds are wall-clock budget spent
                budget = budget - st.dead_s
        else:
            budget = budget_s
        # node-local re-estimate: base time, drift-corrected, at node speed —
        # gathered straight from the base arrays (``est * drift / speed``
        # elementwise is the same float chain the old per-block
        # ``dataclasses.replace`` produced) and planned SoA-native;
        # ``plan_dvfs`` is a thin wrapper over ``plan_dvfs_arrays``, so the
        # resulting queue is bitwise the object path's
        idx, _ = self.queued_arrays(name)
        if skip:
            if len(idx) <= skip:
                return      # nothing behind the protected head
            idx = idx[skip:]
        pos = self._pos_of(idx)
        ba = self._ba
        est_loc = ba.est_time_fmax[pos]
        if self._wscale:    # salvaged remainders re-plan at their true size
            est_loc = est_loc * self._scale_arr(idx)
        local = BlockArrays(
            idx, est_loc * st.drift / st.spec.speed,
            ba.est_rel_halfwidth[pos], ba.util[pos],
            ba.roofline.select(pos) if ba.roofline is not None else None,
            None)
        pa = plan_dvfs_arrays(local, max(budget, 1e-9), planner="global",
                              ladder=st.spec.ladder, power=st.spec.power,
                              error_margin=self.error_margin)
        if skip:
            q, o = st.queue, st.queue.off
            st.queue = _SoAQueue(
                np.concatenate((q.idx[o:o + skip], pa.index)),
                np.concatenate((q.freq[o:o + skip], pa.rel_freq)),
                np.concatenate((q.pred_t[o:o + skip], pa.pred_time_s)),
                np.concatenate((q.pred_e[o:o + skip], pa.pred_energy_j)),
                np.concatenate((q.slot[o:o + skip],
                                np.full(len(pa.index), pa.slot_s))))
        else:
            st.queue = _SoAQueue.from_plan_arrays(pa)
        st.drift_at_replan = st.drift
        st.last_feasible = pa.feasible
        st.replans += 1
        st.version += 1
        self.replan_log.append({
            "node": name, "after_block": st.done, "drift": st.drift,
            "budget_s": budget,
            "freqs": tuple(pa.rel_freq.tolist()),
        })
