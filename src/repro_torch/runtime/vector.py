"""Vectorized event engine: fast-forward fault-free stretches in one commit.

``ClusterRuntime`` (``repro_torch.runtime.engine``) advances one event at a time —
three heap operations and a handful of Python float ops per finished block.
At a million blocks that is the whole runtime budget.  This engine keeps the
scalar loop as the frozen oracle and adds an *epoch* fast path on top:

  epoch        whenever the cluster is quiescent (no in-latency switch, no
               pending telemetry, no cap-deferred launch, nothing on the
               migration wire about to land), every node's future is a pure
               chain: finish the in-flight block, launch the next queued
               block, repeat.  Those chains are priced with whole-array
               arithmetic over the SoA truth containers and committed in
               one batch — state, ledger, event log, and controller all
               advance by ``c`` blocks per node without touching the heap.

  horizon      a chain stops where the scalar engine would do *anything*
               but finish-and-relaunch: the next time-based fault, a replan
               the drift EWMA would trigger (``scan_observations`` simulates
               the detector bitwise), a launch that needs the frequency
               machinery (planned freq != hardware freq under actuation
               latency), a block still on the migration wire, a power-cap
               violation, or a migration trigger armed on the node.  The
               epoch commits strictly before the earliest stop and hands
               the event back to the scalar loop, which handles it with
               full fidelity — then the next epoch resumes.

  bit-identity every committed quantity reproduces the scalar float chains
               op for op: ``np.cumsum`` for sequential ``+=`` accumulators,
               per-unique-frequency Python ``**`` for the power law, the
               exact ``(total - old) + new`` grouping of ``PowerLedger.fits``
               for cap tests, and a ``(time, kind, node)`` sort that equals
               the heap's total order (chains stop at any same-timestamp
               collision a sort cannot reproduce).  The property suite
               (``tests/test_runtime_vector.py``) holds the report AND the
               event log equal to the scalar oracle across faults,
               migration, power caps, actuation latency, and drifting
               hardware.

Trace emission (``config.trace`` / ``config.calibrator``) needs per-segment
samples in handler order, so those runs take the scalar path unchanged —
``run_cluster(engine="auto")`` still works, it just never fast-forwards.

Copied from ``src/repro/runtime/vector.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.runtime.actuator import InFlight
from repro_torch.runtime.engine import ClusterRuntime, RuntimeConfig, RuntimeReport
from repro_torch.runtime.events import (BLOCK_FINISH, BLOCK_START, FAULT,
                                  FREQ_SWITCH, JOB_ARRIVAL, KIND_NAMES,
                                  NODE_DOWN, NODE_UP, TELEMETRY,
                                  WIRE_RELEASE, Event)

__all__ = ["VectorClusterRuntime"]

# heap kinds an epoch may coexist with: pending finishes (the chains resume
# them), scheduled faults (the epoch horizon stops before them), and stale
# frequency switches (pending_target is None on every node, so they no-op)
_EPOCH_KINDS = frozenset((BLOCK_FINISH, FREQ_SWITCH, FAULT))
_MIN_COMMIT = 16     # epochs smaller than this escalate the retry backoff
_BACKOFF0 = 4
_BACKOFF_MAX = 4096
_COOLDOWN_CHEAP = 2  # events between attempts after a cheap precondition fail
_CHUNK0 = 512        # initial per-node chain length an attempt prices


class VectorClusterRuntime(ClusterRuntime):
    """``ClusterRuntime`` with batched fault-free fast-forward epochs.

    Drop-in: same constructor, same ``run()`` contract, bit-identical
    reports and event logs.  ``run_cluster(engine="vector")`` (and the
    default ``"auto"``) select it; ``engine="scalar"`` keeps the oracle.
    """

    def __init__(self, plan, truth, *, config: RuntimeConfig = RuntimeConfig(),
                 events=(), est_blocks=None, true_nodes=None):
        super().__init__(plan, truth, config=config, events=events,
                         est_blocks=est_blocks, true_nodes=true_nodes)
        # sorted fault schedule + a pop cursor: the epoch horizon needs
        # "earliest unprocessed fault" in O(1)
        self._fault_times = np.sort(np.fromiter(
            (fe.time for fe in self._fault_events), np.float64,
            count=len(self._fault_events)))
        self._fault_ptr = 0
        # trace/calibration runs need per-segment samples in handler order
        self._vector_ok = not self._emit_trace
        self._backoff = _BACKOFF0
        # base-estimate SoA lookup for the controller's drift scan — the
        # controller's own base arrays (truth-shared when est_blocks is None)
        self._b_sorted = self._b_order = self._b_est = self._b_roof = None
        if self.controller is not None:
            ctl = self.controller
            self._b_sorted, self._b_order = ctl._ba_sorted, ctl._ba_order
            self._b_est = ctl._ba.est_time_fmax
            self._b_roof = ctl._ba.roofline
        # contiguous 0..n-1 block indices (the SoA build default) make the
        # index->position maps the identity — skip the searchsorted entirely
        nt = len(self._t_sorted)
        self._t_ident = bool(np.array_equal(self._t_sorted,
                                            np.arange(nt, dtype=np.int64)))
        self._b_ident = (self._b_sorted is not None
                         and bool(np.array_equal(
                             self._b_sorted,
                             np.arange(len(self._b_sorted),
                                       dtype=np.int64))))
        # per-node priced-queue cache: pure functions of queue content keyed
        # by the controller's (version, hw) — head pops slice, restructures
        # rebuild.  The drift-scan cache additionally keys on anything that
        # could desync the simulated EWMA continuation (fault count, cap
        # clamps, hardware frequency).
        self._arr_cache: dict = {}
        self._scan_cache: dict = {}
        self._wire_arr = np.empty(0, np.int64)   # _mig_ready keys, cached
        # per-node chain chunk: price ~2x what the last epoch committed
        # instead of the whole remaining queue every attempt
        self._chunk: dict = {}

    def _fault(self, now, st, data):
        self._fault_ptr += 1
        super()._fault(now, st, data)

    def _on_truth_extended(self):
        """Arrived blocks replaced the truth/base arrays (open-loop serving)
        — refresh every cached view so pricing reads the extended copies.
        Closed-batch runs never reach this."""
        nt = len(self._t_sorted)
        self._t_ident = bool(np.array_equal(self._t_sorted,
                                            np.arange(nt, dtype=np.int64)))
        if self.controller is not None:
            ctl = self.controller
            self._b_sorted, self._b_order = ctl._ba_sorted, ctl._ba_order
            self._b_est = ctl._ba.est_time_fmax
            self._b_roof = ctl._ba.roofline
            self._b_ident = bool(np.array_equal(
                self._b_sorted,
                np.arange(len(self._b_sorted), dtype=np.int64)))
        self._arr_cache.clear()
        self._scan_cache.clear()

    # --- vectorized pricing (bitwise mirrors of the scalar paths) ------------
    def _vec_true_time(self, pos, st, freq):
        """``ClusterRuntime._true_time`` over arrays, op for op."""
        est = self._t_est[pos]
        fv = np.maximum(freq, 1e-6)
        roof = self._t_roof
        if roof is not None:
            tc, tm = roof.t_comp[pos], roof.t_mem[pos]
            tl, tf = roof.t_coll[pos], roof.t_fixed[pos]
            at_f = np.maximum(np.maximum(tc / fv, tm), tl) + tf
            at_1 = np.maximum(np.maximum(tc / 1.0, tm), tl) + tf
            base = np.where(roof.has[pos],
                            at_f * (est / np.maximum(at_1, 1e-12)), est / fv)
        else:
            base = est / fv
        return base / st.true_spec.speed

    def _vec_power(self, pm, util, freq):
        """``PowerModel.power`` over arrays; the ``f ** alpha`` stays a
        Python float pow per unique ladder state — ``np.power`` may differ
        from the scalar in the last bit."""
        u = np.clip(util, 0.0, 1.0)
        fc = np.clip(freq, 0.0, 1.0)
        pw = np.empty_like(fc)
        for f in np.unique(fc).tolist():
            pw[fc == f] = f ** pm.alpha
        return pm.p_idle + (pm.p_full - pm.p_idle) * u * pw

    def _t_pos(self, idx):
        """Truth-array positions for an array of global block indices."""
        if self._t_ident:
            return idx
        return self._t_order[np.searchsorted(self._t_sorted, idx)]

    def _vec_base_pred(self, spec, idx, freq):
        """``NodeSpec.block_time`` on the controller's BASE estimates over
        arrays — the denominator of the drift ratio, priced off the node's
        belief spec at the queue's planned frequency."""
        pos = idx if self._b_ident \
            else self._b_order[np.searchsorted(self._b_sorted, idx)]
        est = self._b_est[pos]
        fv = np.maximum(freq, 1e-6)
        roof = self._b_roof
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

    # --- one node's priced chain ---------------------------------------------
    def _chain(self, st):
        """Price the node's fault-free future; returns ``(chain, horizon)``.

        ``chain`` is None when the node cannot fast-forward at all (its
        next telemetry may arm the migration policy); ``horizon`` is the
        earliest time at which something non-chain happens on this node
        (``inf`` when the whole queue drains cleanly).  Element 0 is the
        in-flight block; elements ``1..L`` are the queued blocks the chain
        could launch.  All arrays are element-indexed: ``times[i]`` is
        element i's finish, a launch of element i happens at ``times[i-1]``.
        """
        fl = st.inflight
        t0 = fl.seg_start + fl.seg_time   # == the pending BLOCK_FINISH time
        name = st.spec.name
        ctl = self.controller
        cfg = self.config
        if cfg.migrate and not st.migrate_stuck \
                and not ctl.node_feasible(name):
            # the next telemetry runs the migration trigger — scalar ground
            return None, float(t0)
        latency = cfg.actuation.latency_s
        done = 0
        cap = self._chunk.get(name, _CHUNK0)
        if ctl is not None:
            # priced-queue cache: everything below is a pure function of
            # (queue content, hardware freq under latency), so head pops
            # between epochs just slice the cached arrays.  Pricing covers
            # only a chunk-sized PREFIX of the queue — rebuild cost tracks
            # what epochs actually commit, not the whole remaining tail
            ver, done = ctl.queue_state(name)
            hwk = st.hw_freq if latency > 0.0 else None
            ce = self._arr_cache.get(name)
            if ce is None or ce["key"] != (ver, hwk) \
                    or not (ce["full"]
                            or done - ce["done0"] + cap + 1 <= ce["cov"]):
                qi_full, qf_full = ctl.queued_arrays(name)
                cov = min(len(qi_full), max(4 * cap, 4 * _CHUNK0) + 2)
                q_idx, q_freq = qi_full[:cov], qf_full[:cov]
                pos_q = self._t_pos(q_idx)
                util_q = self._t_util[pos_q]
                f_run_q = np.full(cov, st.hw_freq) \
                    if latency > 0.0 else q_freq
                tt_q = self._vec_true_time(pos_q, st, f_run_q)
                bp_q = self._vec_base_pred(ctl.node_spec_of(name),
                                           q_idx, q_freq)
                if self._work_scale:
                    # checkpoint-salvaged remainders: the same per-block
                    # scale the scalar folds into _scaled_true_time and the
                    # controller into _record — t * s with s == 1.0 is
                    # bitwise t, so only salvaged blocks move.  Crashes
                    # bump the controller version, so the cache re-keys
                    # whenever the scale dict can have changed.
                    sc_q = self._scale_of(q_idx)
                    tt_q = tt_q * sc_q
                    bp_q = bp_q * sc_q
                ce = {"key": (ver, hwk), "done0": done,
                      "cov": cov, "full": cov == len(qi_full),
                      "idx": q_idx, "freq": q_freq, "pos": pos_q,
                      "f_run": f_run_q,
                      "tt": tt_q,
                      "p_run": self._vec_power(st.true_spec.power, util_q,
                                               f_run_q),
                      "bp": bp_q,
                      # wire membership is version-stable too: migration
                      # appends bump the dst's version, and only a queue
                      # HEAD ever leaves the wire (behind the offset)
                      "wire": (np.isin(q_idx, self._wire_arr)
                               if len(self._wire_arr) else None)}
                self._arr_cache[name] = ce
            off = done - ce["done0"]
            q_idx = ce["idx"][off:]
            if len(q_idx) == 0 or int(q_idx[0]) != fl.block_index:
                return None, float(t0)   # head out of sync: stay scalar
            # duration/time cache: np.cumsum's partial sums ARE the scalar
            # engine's sequential additions, so a later attempt's event
            # times extend the same float chain — a bitwise t0 match at the
            # inflight's slot proves nothing re-priced the chain under us
            # (a split, cap clamp, idle gap or wire wait all land OFF the
            # chain and force a re-price; faults re-key it explicitly)
            hit = False
            if ce.get("fptr") == self._fault_ptr:
                j0 = done - ce["ddone0"]
                if 0 <= j0 < ce["m_ok"] and ce["times"][j0] == t0:
                    hit = True
            if not hit:
                tt_v = ce["tt"][off:]   # slot 0 = the current inflight
                m = len(tt_v)
                if st.slow_events:
                    # block-count slowdowns at each element's LAUNCH
                    # (slot k launches when the node's done == done_p + k);
                    # successive *= in sorted event order, multiplying by
                    # 1.0 where an event has not triggered — x * 1.0 is
                    # bitwise x
                    count = np.ones(m)
                    done_at = st.done + np.arange(m)
                    for after_block, fac in st.slow_events:
                        count = count * np.where(done_at >= after_block,
                                                 fac, 1.0)
                    durs_all = tt_v * (count * st.fault_factor)
                else:
                    durs_all = tt_v * st.fault_factor
                times_all = np.cumsum(
                    np.concatenate(([t0], durs_all[1:])))
                # event times must STRICTLY increase along the chain: a
                # duration that rounds t + d == t would interleave
                # same-timestamp events in heap order, which a batch sort
                # cannot reproduce — the chain may never extend past the
                # first flat step (the oracle walks through it)
                flat = np.flatnonzero(times_all[1:] <= times_all[:-1])
                ce["m_ok"] = int(flat[0]) + 1 if len(flat) else m
                ce["durs"], ce["times"] = durs_all, times_all
                ce["en"] = durs_all * ce["p_run"][off:]
                ce["ddone0"], ce["fptr"] = done, self._fault_ptr
                j0 = 0
            fresh_idx, fresh_freq = q_idx[1:], ce["freq"][off + 1:]
            f_run = ce["f_run"][off + 1:]
            pos = ce["pos"][off + 1:]
            p_run_c = ce["p_run"][off + 1:]
            bp_all = ce["bp"][off:]
            durs_v = ce["durs"][j0 + 1:]
            times_v = ce["times"][j0:]
            en_v = ce["en"][j0 + 1:]
            avail = ce["m_ok"] - 1 - j0   # priceable fresh elements
        else:
            fresh_idx = st.idx[st.ptr + 1:]
            fresh_freq = st.freq[st.ptr + 1:]
            f_run = np.full(len(fresh_idx), st.hw_freq) \
                if latency > 0.0 else fresh_freq
            pos = self._t_pos(fresh_idx)
            tt = self._vec_true_time(pos, st, f_run)
            p_run_c = self._vec_power(st.true_spec.power,
                                      self._t_util[pos], f_run)
            bp_all = None
        L = len(fresh_idx)
        blocked = False   # element L+1 exists but needs the scalar machinery
        if ctl is not None and avail < L:
            # the cached time chain ends here (flat step, or priced from an
            # older anchor) — element avail+1 straddles back to the oracle
            L, blocked = avail, True
        # chunk cap: price only ~2x what the last epoch committed (grown
        # geometrically below).  A capped element is exactly a "blocked"
        # straddler — the commit horizon stops at its launch, the scalar
        # loop replays it — so the only cost of undersizing is one more
        # attempt, and the win is O(committed) instead of O(queue) pricing
        if L > cap:
            L, blocked = cap, True
        if latency > 0.0 and L:
            # with actuation latency a launch starts at the HARDWARE
            # frequency; any planned freq off it would arm pending_target
            mism = np.abs(fresh_freq[:L] - st.hw_freq) > 1e-12
            if mism.any():
                L, blocked = int(np.argmax(mism)), True
        if L and ctl is not None and ce["wire"] is not None:
            # a migrated block may still be on the wire at launch time —
            # conservatively give every wire block back to the scalar path
            # (the membership mask is cached with the priced queue; a stale
            # True only over-truncates, and the straddle replay re-checks)
            on_wire = ce["wire"][off + 1:off + 1 + L]
            if on_wire.any():
                L, blocked = int(np.argmax(on_wire)), True
        fresh_idx = fresh_idx[:L]
        f_run, pos = f_run[:L], pos[:L]
        if ctl is not None:
            durs = durs_v[:L]
            times = times_v[:L + 1]
            en_fresh = en_v[:L]
        else:
            # block-count slowdowns at each element's LAUNCH (done = D + i);
            # successive *= in sorted event order, multiplying by 1.0 where
            # an event has not triggered — x * 1.0 is bitwise x
            count = np.ones(L)
            if st.slow_events and L:
                done_at = st.done + 1 + np.arange(L)
                for after_block, fac in st.slow_events:
                    count = count * np.where(done_at >= after_block,
                                             fac, 1.0)
            durs = tt[:L] * (count * st.fault_factor)
            times = np.cumsum(np.concatenate(([t0], durs)))
            # event times must STRICTLY increase along the chain: a duration
            # short enough to round t + d == t would interleave
            # same-timestamp finish/telemetry/start events in heap order,
            # which a batch sort cannot reproduce — stop the chain there
            if L:
                flat = times[1:] <= times[:-1]
                if flat.any():
                    L, blocked = int(np.argmax(flat)), True
                    fresh_idx = fresh_idx[:L]
                    f_run, pos = f_run[:L], pos[:L]
                    durs, times = durs[:L], times[:L + 1]
            en_fresh = durs * p_run_c[:L]
        util0 = float(self._t_util[fl.block_pos])
        obs = np.concatenate(([fl.busy_s + fl.seg_time], durs))
        e0 = fl.energy_j + st.true_spec.power.busy_energy(
            fl.seg_time, fl.rel_freq, util=util0)
        p_run = p_run_c[:L]
        energy = np.concatenate(([e0], en_fresh))
        f_end = np.concatenate(([fl.rel_freq], f_run))
        idx_all = np.concatenate(([fl.block_index], fresh_idx))
        pos_all = np.concatenate(([fl.block_pos], pos))
        # a blocked element only ever STRADDLES the cutoff (strict-< commit
        # at times[L] keeps element L the last launch), so the scalar loop
        # replays its launch with the full frequency/cap/wire machinery
        horizon = float(times[L]) if blocked else np.inf
        base_pred = None
        if ctl is not None:
            base_pred = bp_all[:L + 1]
            obs_len = L + 1
            # drift-scan cache: the simulated EWMA walk from the current
            # detector state is a pure continuation of the last full scan as
            # long as nothing re-priced a block out from under it — queue
            # restructures (version), faults, cap clamps and mid-block
            # splits (_off_plan) all void it, and so does a hardware-freq
            # change under latency (durations price at hw there; hwk is
            # None at zero latency where hw cannot matter).  Positions are
            # absolute (in ``done`` space), so commits shift the trigger.
            skey = (ver, hwk, self._fault_ptr, self._off_plan)
            sc = self._scan_cache.get(name)
            k = None
            if sc is not None and sc[0] == skey:
                k_abs, upto = sc[1], sc[2]
                if k_abs is not None:
                    kr = k_abs - done
                    if kr >= 0:
                        k = kr if kr < obs_len else obs_len
                elif done + obs_len <= upto:
                    k = obs_len
            if k is None:
                k = ctl.scan_observations(name, obs, base_pred)
                self._scan_cache[name] = (
                    skey, (done + k) if k < obs_len else None,
                    done + obs_len)
            if k < obs_len:   # observation k re-plans: stop before it lands
                horizon = min(horizon, float(times[k]))
        return {"st": st, "L": L, "times": times, "obs": obs,
                "energy": energy, "f_end": f_end, "idx": idx_all,
                "pos": pos_all, "p_run": p_run, "durs": durs,
                "base_pred": base_pred}, horizon

    # --- the epoch -----------------------------------------------------------
    def _attempt_epoch(self):
        """Try one batched fast-forward; returns committed event count, or
        None when a cheap precondition already rules the epoch out."""
        for st in self.nodes:
            if st.pending_target is not None or st.want_up is not None \
                    or st.waiting:
                return None
        if self._pending_tel:
            return None
        # scheduled wakeups (a migrated block's wire sleep) and wire
        # releases fire in the FUTURE at a quiet boundary: they bound the
        # commit horizon instead of vetoing the epoch outright
        t_bound = float("inf")
        wake = set()
        for entry in self.queue._heap:
            kind = entry[1]
            if kind in _EPOCH_KINDS:
                continue
            if kind == TELEMETRY:
                return None
            if entry[0] < t_bound:
                t_bound = entry[0]
            if kind == BLOCK_START:
                wake.add(entry[2])
        ctl = self.controller
        active = []
        for st in self.nodes:
            if not st.up:
                # a down node runs nothing; its NODE_UP (if any) is in the
                # heap as a non-epoch kind and already bounds the horizon
                continue
            if st.inflight is not None:
                active.append(st)
            elif (ctl.next_block_brief(st.spec.name) is not None
                  if ctl is not None else st.ptr < len(st.idx)):
                # idle node with queued work: fine if its wakeup is already
                # scheduled (the horizon stops before it fires), otherwise
                # a same-time cascade is still in flight — stay scalar
                if st.nid not in wake:
                    return None
        if not active:
            return None

        t_c = float(self._fault_times[self._fault_ptr]) \
            if self._fault_ptr < len(self._fault_times) else float("inf")
        if t_bound < t_c:
            t_c = t_bound
        # wire set snapshot, shared by every chain this attempt (the scalar
        # interludes between epochs are what mutate _mig_ready)
        n_wire = len(self._mig_ready)
        if n_wire or len(self._wire_arr):
            self._wire_arr = np.fromiter(self._mig_ready.keys(), np.int64,
                                         count=n_wire)
        chains = []
        for st in active:
            ch, h = self._chain(st)
            if h < t_c:
                t_c = h
            if ch is not None:
                chains.append(ch)
        if not chains:
            return 0

        # --- ledger replay: every committed finish (draw -> idle) and launch
        # (idle -> busy draw) in the heap's (time, kind, node) total order,
        # carrying the per-event (old, new) watts so both scalar groupings —
        # set_draw's total + (new - old) and fits' (total - old) + new —
        # replay exactly
        led = self.ledger
        r_time, r_kind, r_nid, r_old, r_new = [], [], [], [], []
        for ch in chains:
            st, times = ch["st"], ch["times"]
            c = int(np.searchsorted(times, t_c, side="left"))
            ch["c"] = c
            if c == 0:
                continue
            lam = c if c <= ch["L"] else ch["L"]   # committed launches 1..lam
            ch["lam"] = lam
            idle_w = led._idle[st.nid]
            p_run = ch["p_run"]
            r_time.append(times[:c])
            r_kind.append(np.zeros(c, np.int64))          # BLOCK_FINISH == 0
            r_nid.append(np.full(c, st.nid, np.int64))
            r_old.append(np.concatenate(([led.draw_of(st.nid)],
                                         p_run[:c - 1])))
            r_new.append(np.full(c, idle_w))
            if lam:
                r_time.append(times[:lam])
                r_kind.append(np.full(lam, BLOCK_START, np.int64))
                r_nid.append(np.full(lam, st.nid, np.int64))
                r_old.append(np.full(lam, idle_w))
                r_new.append(p_run[:lam])
        time_a = np.concatenate(r_time) if r_time else np.empty(0)
        if len(time_a) == 0:
            return 0
        kind_a = np.concatenate(r_kind)
        nid_a = np.concatenate(r_nid)
        old_a = np.concatenate(r_old)
        new_a = np.concatenate(r_new)
        order = np.lexsort((nid_a, kind_a, time_a))
        time_s, kind_s = time_a[order], kind_a[order]
        old_s, new_s = old_a[order], new_a[order]
        totals = np.cumsum(np.concatenate(([led.total_w], new_s - old_s)))
        if led.cap_w is not None:
            # PowerLedger.fits' exact grouping and tolerance; only launches
            # raise the draw, so only they can violate
            fit = (totals[:-1] - old_s) + new_s <= led.cap_w + 1e-9
            viol = (kind_s == BLOCK_START) & ~fit
            if viol.any():
                # truncate to strictly before the first violating launch —
                # the surviving prefix was already cap-checked, and the
                # violating launch replays through the scalar clamp/defer
                t_c = float(time_s[int(np.argmax(viol))])
                cut = int(np.searchsorted(time_s, t_c, side="left"))
                if cut == 0:
                    return 0
                time_s, kind_s = time_s[:cut], kind_s[:cut]
                old_s, new_s = old_s[:cut], new_s[:cut]
                totals = totals[:cut + 1]
                for ch in chains:
                    c = int(np.searchsorted(ch["times"], t_c, side="left"))
                    ch["c"] = c
                    ch["lam"] = c if c <= ch["L"] else ch["L"]
        committed = len(time_s)
        if committed == 0:
            return 0

        # --- commit: ledger first, then per-node state, log last ------------
        led.total_w = float(totals[-1])
        led.peak_w = max(led.peak_w, float(totals[1:].max()))
        if led._record:
            led.samples.extend(zip(time_s.tolist(), totals[1:].tolist()))
        if self._mx is not None:
            self._mx.on_power_batch(time_s, totals[1:])
        entries = [] if self._log_on else None
        # flight-recorder mode: rows deeper than the ring capacity in this
        # commit are evicted unread — materialize only each chain's tail
        # (a contiguous suffix of its sorted event sequence) and account
        # the rest through the sink's pushed counter
        ring_n = None
        if entries is not None and not isinstance(self.log, list):
            ring_n = self.log.capacity
        skipped = 0
        for ch in chains:
            c = ch["c"]
            if c == 0:
                continue
            st, lam, times = ch["st"], ch["lam"], ch["times"]
            obs, energy = ch["obs"], ch["energy"]
            f_end, idx_all, p_run = ch["f_end"], ch["idx"], ch["p_run"]
            # sequential += chains, reproduced with cumsum
            st.busy_s = float(np.cumsum(
                np.concatenate(([st.busy_s], obs[:c])))[-1])
            st.energy_j = float(np.cumsum(
                np.concatenate(([st.energy_j], energy[:c])))[-1])
            st.freqs.extend(f_end[:c].tolist())
            st.done += c
            if self._has_failures:
                self._done_idx.extend(idx_all[:c].tolist())
            st.finish_s = float(times[c - 1])
            if ctl is not None:
                ctl.commit_observations(st.spec.name, obs[:c],
                                        ch["base_pred"][:c])
            else:
                st.ptr += c
            if lam:
                # boundary transitions: launch i switched iff its frequency
                # differs (exact !=, as the scalar) from the previous one
                prev = np.concatenate(([st.hw_freq], f_end[1:lam]))
                n_sw = int(np.count_nonzero(f_end[1:lam + 1] != prev))
                if n_sw:
                    se = self.config.actuation.switch_energy_j
                    st.n_switches += n_sw
                    st.switch_energy_j = float(np.cumsum(np.concatenate(
                        ([st.switch_energy_j], np.full(n_sw, se))))[-1])
                st.hw_freq = float(f_end[lam])
            if lam == c:
                # element c launched but did not finish: it straddles the
                # cutoff as a fresh in-flight block (its old BLOCK_FINISH
                # heap entry, if any, goes stale via the index guard)
                fl = InFlight(block_pos=int(ch["pos"][c]),
                              block_index=int(idx_all[c]),
                              rel_freq=float(f_end[c]),
                              seg_start=float(times[c - 1]),
                              seg_time=float(ch["durs"][c - 1]),
                              freqs=(float(f_end[c]),),
                              generation=st.gen_base)
                st.inflight = fl
                led._draw[st.nid] = float(p_run[c - 1])
                self.queue.push(Event(float(times[c]), BLOCK_FINISH, st.nid,
                                      (fl.block_index, fl.generation)))
            else:
                st.inflight = None
                led._draw[st.nid] = led._idle[st.nid]
            if self._mx is not None:
                self._mx.commit_chain(st.nid, times, obs, energy, f_end,
                                      c, lam)
            if entries is not None:
                nid = st.nid
                i0 = 0
                if ring_n is not None and c > ring_n + 2:
                    # keep >= ring_n trailing events of this chain: element
                    # i's events all land at times in [times[i-1], times[i]],
                    # so elements >= i0 are a sorted-suffix superset of the
                    # chain's last ring_n rows
                    i0 = c - (ring_n + 2)
                    skipped += i0 * (2 if ctl is not None else 1)
                tl, ol = times.tolist(), obs.tolist()
                el, il, fe = energy.tolist(), idx_all.tolist(), f_end.tolist()
                for i in range(i0, c):
                    entries.append((tl[i], BLOCK_FINISH, nid,
                                    (il[i], ol[i], el[i])))
                    if ctl is not None:
                        entries.append((tl[i], TELEMETRY, nid,
                                        (il[i], ol[i], False)))
                lo = max(1, i0)
                skipped += min(lam, lo - 1)
                for i in range(lo, lam + 1):
                    entries.append((tl[i - 1], BLOCK_START, nid,
                                    (il[i], fe[i])))
        if skipped:
            self.log.skip(skipped)
        if entries:
            entries.sort(key=lambda e: (e[0], e[1], e[2]))
            name_of = [st.spec.name for st in self.nodes]
            self.log.extend([(t, KIND_NAMES[k], name_of[n]) + d
                             for t, k, n, d in entries])
        for ch in chains:
            # next attempt prices ~2x what this one committed (floor keeps
            # short interludes from starving the next long stretch)
            self._chunk[ch["st"].spec.name] = max(2 * ch["c"], _CHUNK0)
        return committed

    # --- main loop -----------------------------------------------------------
    def run(self) -> RuntimeReport:
        if self._ran:
            raise RuntimeError("a ClusterRuntime instance runs exactly once")
        self._ran = True
        self._seed_queue()
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
        # epoch attempts only fire at QUIET BOUNDARIES — the heap head's
        # time is strictly past the last popped event, so every same-time
        # finish/telemetry/start cascade has fully drained (attempting
        # mid-cascade can never succeed).  A deterministic cooldown
        # amortizes the attempts: a cheap precondition fail retries at the
        # next few boundaries, a fruitless full attempt (which priced whole
        # queues) backs off exponentially, and a big commit resets it.
        cooldown = 0
        last_t = float("-inf")
        vector_ok = self._vector_ok
        while self.queue:
            if vector_ok and cooldown <= 0 \
                    and self.queue._heap[0][0] > last_t:
                done = self._attempt_epoch()
                if done is None:
                    cooldown = _COOLDOWN_CHEAP
                elif done >= _MIN_COMMIT:
                    self._backoff = _BACKOFF0
                    cooldown = _COOLDOWN_CHEAP
                else:
                    self._backoff = min(self._backoff * 2, _BACKOFF_MAX)
                    cooldown = self._backoff
                if not self.queue:
                    break
            else:
                cooldown -= 1
            ev = self.queue.pop()
            last_t = ev.time
            st = self.nodes[ev.node]
            if ev.kind == BLOCK_START:
                self._start_block(ev.time, st)
            else:
                handlers[ev.kind](ev.time, st, ev.data)
        return self._report()
