"""Streaming metrics: a bounded-memory rolling aggregator over the runtime.

``StreamingMetrics`` is the inline sink ``RuntimeConfig(metrics=...)``
feeds while a run executes — per-node utilization, the instantaneous
(compute + aux) cluster power-draw timeline, queue depth, energy and busy
accumulators, and shed / reject / crash / migration event rates — without
ever materializing the event log.  Memory is O(bins + nodes), independent
of run length: timelines live in a fixed number of bins over a growing
horizon (the horizon doubles and the bins pairwise-merge when events run
past it), and the hot feeds buffer into small pending lists that flush
through vectorized scatters.

Two feed rates, one aggregate: the scalar engine (and the vector engine's
scalar interludes) call the per-event hooks; the vector engine's epoch
commits call ``commit_chain`` / ``on_power_batch`` with whole arrays, so
fast-forwarded runs keep fast-forwarding — the ≤ 5 % overhead contract of
the ``obs`` benchmark section hangs on exactly this.

Timeline semantics: ``power_timeline`` and ``util_timeline`` are
time-weighted per-bin means of the underlying piecewise-constant signal
(exact within each bin — intervals scatter as partial-bin remainders plus
a full-bin carry, not by sampling).  ``depth_timeline`` is the backlog
gauge at bin granularity (net per-bin deltas, order-independent).

The post-hoc half of this module — ``node_rows`` / ``tenant_rows`` /
``format_table`` — renders per-node and per-tenant tables straight off a
``RuntimeReport`` / ``ServingReport`` (what ``examples/cluster_sim.py``
prints instead of hand-rolled folds).

Copied from ``src/repro/obs/metrics.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["StreamingMetrics", "node_rows", "tenant_rows", "format_table"]

_RATE_KINDS = ("finish", "migrate", "crash", "shed", "reject")
_FLUSH = 1024       # scalar pending-list flush threshold (tuples)
_VFLUSH = 16384     # vector pending-batch flush threshold (array elements)


class StreamingMetrics:
    """Inline metrics sink for ``RuntimeConfig(metrics=...)``.

    STATEFUL: the engine binds it at construction and feeds it for the
    whole run — construct a fresh instance per run.  Every query method
    may be called mid-run (it flushes the pending buffers) or after
    ``on_run_end`` sealed the final report.
    """

    def __init__(self, *, bins: int = 256, horizon_s: float | None = None):
        if bins < 2 or bins % 2:
            raise ValueError("bins must be an even integer >= 2")
        self.bins = bins
        self._H = float(horizon_s) if horizon_s else 0.0
        self.node_names: tuple = ()
        self.deadline_s = 0.0
        self.counters = {k: 0 for k in (
            "launches", "finishes", "defers", "migrations", "crashes",
            "repairs", "sheds", "late_blocks", "jobs_accepted",
            "jobs_rejected", "jobs_deferred", "wakes", "parks")}
        self.report = None            # sealed by on_run_end
        self.power_cap_w = None       # read off the engine config at bind
        self.tenant_counters: dict = {}   # tenant -> decision counts
        self.tenant_slo: dict = {}        # tenant -> last seen SLO seconds
        self._tenant_bins: dict = {}      # tenant -> per-bin reject+shed count
        self._subs: list = []
        self._n = 0
        self._bound = False

    # --- binding -------------------------------------------------------------
    def bind(self, eng) -> None:
        """Called by the engine constructor: node identities, the deadline
        horizon, and the initial backlog."""
        if self._bound:
            raise RuntimeError("a StreamingMetrics instance feeds exactly "
                               "one run — construct a fresh one")
        self._bound = True
        self.power_cap_w = getattr(getattr(eng, "config", None),
                                   "power_cap_w", None)
        self.node_names = tuple(st.spec.name for st in eng.nodes)
        n = self._n = len(self.node_names)
        self.deadline_s = float(eng.deadline_s)
        if self._H <= 0.0:
            self._H = max(self.deadline_s, 1e-9)
        B = self.bins
        self._busy = np.zeros(n)
        self._energy = np.zeros(n)
        self._failed_busy = np.zeros(n)
        self._failed_energy = np.zeros(n)
        self._mig_energy = 0.0
        self._last_freq = np.zeros(n)
        if eng.controller is not None:
            depths = eng.controller.queue_depths()
            self._depth_now = np.array(
                [float(depths.get(nm, 0)) for nm in self.node_names])
        else:
            self._depth_now = np.array(
                [float(len(st.idx) - st.ptr) for st in eng.nodes])
        self.depth0 = float(self._depth_now.sum())
        # time-weighted interval integrals: partial-bin remainder A plus a
        # full-bin carry C (I[j] = A[j] + binw * cumsum(C)[j]) — O(1) per
        # interval no matter how many bins it spans
        self._pA = np.zeros(B)            # cluster power (watts-step track)
        self._pC = np.zeros(B + 1)
        self._uA = np.zeros((n, B))       # per-node busy occupancy
        self._uC = np.zeros((n, B + 1))
        self._depth_bins = np.zeros(B)    # net backlog deltas per bin
        self._rates = np.zeros((len(_RATE_KINDS), B))
        self._last_pt = 0.0               # power step track tail
        self._last_pw = 0.0
        self._have_power = False
        self.peak_power_w = 0.0
        self._end_t = 0.0
        self._pp: list = []               # pending (t, w) power steps
        self._pq: list = []               # pending (ts, ws) power arrays
        self._pq_n = 0
        self._ivp: list = []              # pending (nid, a, b) busy intervals
        self._ivb: list = []              # pending (nid, t, obs, e) commits
        self._ivb_n = 0

    def subscribe(self, sub) -> None:
        """Register an inline consumer (e.g. ``Watchdog``).  Subscribers
        get ``on_seal(metrics, report)`` exactly once, after the final
        flush — the hot feeds never pay a per-event callback."""
        self._subs.append(sub)

    def _need_bound(self):
        if not self._bound:
            raise RuntimeError("metrics not bound to a run yet "
                               "(pass it as RuntimeConfig(metrics=...))")

    # --- binning helpers -----------------------------------------------------
    def _grow_to(self, t: float) -> None:
        while t > self._H:
            B = self.bins
            binw = self._H / B
            # materialize per-bin integrals, then pairwise-merge
            self._pA = self._fold(self._pA + binw * np.cumsum(self._pC[:B]))
            self._pC = np.zeros(B + 1)
            self._uA = self._fold(
                self._uA + binw * np.cumsum(self._uC[:, :B], axis=1))
            self._uC = np.zeros((self._n, B + 1))
            self._depth_bins = self._fold(self._depth_bins)
            self._rates = self._fold(self._rates)
            for k in self._tenant_bins:
                self._tenant_bins[k] = self._fold(self._tenant_bins[k])
            self._H *= 2.0

    def _fold(self, a: np.ndarray) -> np.ndarray:
        if a.ndim == 1:
            out = np.zeros(self.bins)
            out[:self.bins // 2] = a[0::2] + a[1::2]
            return out
        out = np.zeros(a.shape[:-1] + (self.bins,))
        out[..., :self.bins // 2] = a[..., 0::2] + a[..., 1::2]
        return out

    def _bin_of(self, t) -> np.ndarray:
        binw = self._H / self.bins
        return np.minimum((np.asarray(t, dtype=np.float64) / binw)
                          .astype(np.int64), self.bins - 1)

    def _bin1(self, t: float) -> int:
        # pure-python fast path for the scalar per-event hooks (a numpy
        # round-trip per event would dominate the scalar engine's cost)
        b = int(t * self.bins / self._H)
        return b if b < self.bins else self.bins - 1

    def _scatter_intervals(self, A, C, a, b, w, row=None) -> None:
        """Exact time-weighted scatter of weighted intervals [a, b].

        bincount-based (np.add.at is an order of magnitude slower): each
        interval lands as partial-bin remainders at its two end bins plus
        a full-bin carry pair — O(1) per interval regardless of span.
        In-place arithmetic throughout; zero-width intervals cancel to
        nothing on their own, so callers need not mask them out.
        """
        B = self.bins
        binw = self._H / B
        inv = B / self._H
        ia = (a * inv).astype(np.int64)
        np.minimum(ia, B - 1, out=ia)
        ib = (b * inv).astype(np.int64)
        np.minimum(ib, B - 1, out=ib)
        warr = isinstance(w, np.ndarray)
        wa = ia.astype(np.float64)
        wa += 1.0
        wa *= binw
        wa -= a
        wb = ib.astype(np.float64)
        wb += 1.0
        wb *= binw
        wb -= b
        if warr or w != 1.0:
            wa *= w
            wb *= w
        np.negative(wb, out=wb)
        if row is None:
            A += np.bincount(ia, weights=wa, minlength=B)
            A += np.bincount(ib, weights=wb, minlength=B)
            ia += 1                       # carry indices, reusing buffers
            ib += 1
            if warr:
                C += np.bincount(ia, weights=w, minlength=B + 1)
                C -= np.bincount(ib, weights=w, minlength=B + 1)
            else:
                cnt = np.bincount(ia, minlength=B + 1) \
                    - np.bincount(ib, minlength=B + 1)
                C += cnt if w == 1.0 else cnt * w
        else:
            ia += row * B                 # flat indices into A
            ib += row * B
            fa = A.reshape(-1)
            fa += np.bincount(ia, weights=wa, minlength=fa.size)
            fa += np.bincount(ib, weights=wb, minlength=fa.size)
            ia += row                     # row*(B+1) + bin + 1, in place
            ia += 1
            ib += row
            ib += 1
            fc = C.reshape(-1)
            if warr:
                fc += np.bincount(ia, weights=w, minlength=fc.size)
                fc -= np.bincount(ib, weights=w, minlength=fc.size)
            else:
                cnt = np.bincount(ia, minlength=fc.size) \
                    - np.bincount(ib, minlength=fc.size)
                fc += cnt if w == 1.0 else cnt * w

    def _flush(self) -> None:
        self._flush_power()
        self._flush_intervals()

    def _roll_pp(self) -> None:
        # fold the scalar step tuples into the array queue, keeping the
        # chronological append order between the two feeds
        if self._pp:
            m = len(self._pp)
            ts = np.fromiter((p[0] for p in self._pp), np.float64, count=m)
            ws = np.fromiter((p[1] for p in self._pp), np.float64, count=m)
            self._pp.clear()
            self._pq.append((ts, ws))
            self._pq_n += m

    def _flush_power(self) -> None:
        self._roll_pp()
        if self._pq:
            if len(self._pq) == 1:
                ts, ws = self._pq[0]
            else:
                ts = np.concatenate([q[0] for q in self._pq])
                ws = np.concatenate([q[1] for q in self._pq])
            self._pq.clear()
            self._pq_n = 0
            self._push_power_arrays(ts, ws)

    def _flush_intervals(self) -> None:
        """Drain both interval feeds — order-independent, so the scalar
        tuples and the vector chain batches merge into ONE scatter."""
        rows_l, a_l, b_l = [], [], []
        if self._ivp:
            m = len(self._ivp)
            rows_l.append(np.fromiter((p[0] for p in self._ivp), np.int64,
                                      count=m))
            a_l.append(np.fromiter((p[1] for p in self._ivp), np.float64,
                                   count=m))
            b_l.append(np.fromiter((p[2] for p in self._ivp), np.float64,
                                   count=m))
            self._ivp.clear()
        vec_b, e_l = [], []
        for nid, t, o, e in self._ivb:
            rows_l.append(np.full(len(t), nid, np.int64))
            a_l.append(t - o)
            b_l.append(t)
            vec_b.append(t)
            e_l.append(e)
        self._ivb.clear()
        self._ivb_n = 0
        if not rows_l:
            return
        rows = np.concatenate(rows_l)
        a = np.concatenate(a_l)
        b = np.concatenate(b_l)
        self._grow_to(float(b.max()))
        self._scatter_intervals(self._uA, self._uC,
                                np.maximum(a, 0.0), b, 1.0, row=rows)
        # vector-fed finishes settle their deferred reductions here (the
        # scalar hooks already did theirs inline)
        if vec_b:
            nb = sum(len(t) for t in vec_b)  # == rows tail length
            vrows = rows[-nb:]
            vo = a[-nb:]                     # a == t - o on the vector tail
            vb = b[-nb:]
            self._busy += np.bincount(vrows, weights=vb - vo,
                                      minlength=self._n)
            self._energy += np.bincount(vrows, weights=np.concatenate(e_l),
                                        minlength=self._n)
            self.counters["late_blocks"] += int(np.count_nonzero(
                vb > self.deadline_s))
            bi = self._bin_of(vb)
            hits = np.bincount(bi, minlength=self.bins).astype(np.float64)
            self._depth_bins -= hits
            self._rates[0] += hits

    def _push_power_arrays(self, ts, ws) -> None:
        """Fold a chronological step-track segment into the power bins.

        Power samples are contiguous (each sample's time closes the
        previous height's interval), so instead of the generic interval
        scatter we integrate the step function cumulatively and read the
        per-bin energy off linear interpolation at the bin edges — about
        half the passes of the bincount path on the hottest feed.
        """
        self._grow_to(float(ts[-1]))
        xs = np.empty(len(ts) + 1)
        xs[0] = self._last_pt
        xs[1:] = ts
        incr = np.diff(xs)
        incr[0] *= self._last_pw
        incr[1:] *= ws[:-1]
        cum = np.empty(len(ts) + 1)
        cum[0] = 0.0
        np.cumsum(incr, out=cum[1:])
        edges = np.linspace(0.0, self._H, self.bins + 1)
        self._pA += np.diff(np.interp(edges, xs, cum))
        self._last_pt = float(ts[-1])
        self._last_pw = float(ws[-1])
        mx = float(ws.max())
        if mx > self.peak_power_w:
            self.peak_power_w = mx

    # --- scalar feed (engine handlers + ledger observer) ---------------------
    def on_power(self, now: float, total_w: float) -> None:
        if not self._have_power:
            # the very first observation sets the t=0 baseline draw
            self._have_power = True
            self._last_pw = total_w
            self.peak_power_w = total_w
        self._pp.append((now, total_w))
        if len(self._pp) >= _FLUSH:
            self._flush_power()

    def on_launch(self, now, nid, index, f_run) -> None:
        self.counters["launches"] += 1
        self._last_freq[nid] = f_run
        if now > self._end_t:
            self._end_t = now

    def on_finish(self, now, nid, index, busy, energy) -> None:
        c = self.counters
        c["finishes"] += 1
        if now > self.deadline_s:
            c["late_blocks"] += 1
        self._busy[nid] += busy
        self._energy[nid] += energy
        self._depth_now[nid] -= 1.0
        self._ivp.append((nid, now - busy, now))
        if len(self._ivp) >= _FLUSH:
            self._flush()
        if now > self._H:
            self._grow_to(now)
        b = self._bin1(now)
        self._depth_bins[b] -= 1.0
        self._rates[0, b] += 1.0
        if now > self._end_t:
            self._end_t = now

    def on_defer(self, now, nid) -> None:
        self.counters["defers"] += 1

    def on_migrate(self, now, src, dst, energy_j) -> None:
        self.counters["migrations"] += 1
        self._mig_energy += energy_j
        self._depth_now[src] -= 1.0
        self._depth_now[dst] += 1.0
        if now > self._H:
            self._grow_to(now)
        self._rates[1, self._bin1(now)] += 1.0

    def on_crash(self, now, nid, burned_busy, burned_energy) -> None:
        self.counters["crashes"] += 1
        self._failed_busy[nid] += burned_busy
        self._failed_energy[nid] += burned_energy
        if burned_busy > 0.0:
            self._ivp.append((nid, now - burned_busy, now))
        if now > self._H:
            self._grow_to(now)
        self._rates[2, self._bin1(now)] += 1.0

    def on_repair(self, now, nid, down_s) -> None:
        self.counters["repairs"] += 1

    # --- serving feed --------------------------------------------------------
    def _tenant_pressure(self, tenant, now) -> None:
        # per-tenant SLO-denying outcome (reject or shed) binned in time —
        # the watchdog's tenant burn-rate input
        arr = self._tenant_bins.get(tenant)
        if arr is None:
            arr = self._tenant_bins[tenant] = np.zeros(self.bins)
        arr[self._bin1(now)] += 1.0

    def on_job(self, now, tenant, decision, slo_s=None) -> None:
        key = {"accept": "jobs_accepted", "reject": "jobs_rejected",
               "defer": "jobs_deferred"}.get(decision)
        if key is not None:
            self.counters[key] += 1
        tc = self.tenant_counters.get(tenant)
        if tc is None:
            tc = self.tenant_counters[tenant] = {
                "accept": 0, "reject": 0, "defer": 0, "shed": 0}
        if decision in tc:
            tc[decision] += 1
        if slo_s is not None:
            self.tenant_slo[tenant] = float(slo_s)
        if decision == "reject":
            if now > self._H:
                self._grow_to(now)
            self._rates[4, self._bin1(now)] += 1.0
            self._tenant_pressure(tenant, now)

    def on_accept(self, now, nid, nblocks) -> None:
        self._depth_now[nid] += float(nblocks)
        if now > self._H:
            self._grow_to(now)
        self._depth_bins[self._bin1(now)] += float(nblocks)

    def on_shed(self, now, nid, tenant, nblocks) -> None:
        self.counters["sheds"] += 1
        tc = self.tenant_counters.get(tenant)
        if tc is not None:
            tc["shed"] += 1
        self._depth_now[nid] -= float(nblocks)
        if now > self._H:
            self._grow_to(now)
        b = self._bin1(now)
        self._depth_bins[b] -= float(nblocks)
        self._rates[3, b] += 1.0
        self._tenant_pressure(tenant, now)

    def on_provision(self, now, nid, what) -> None:
        self.counters["wakes" if what == "wake" else "parks"] += 1

    # --- vector feed (epoch commits) -----------------------------------------
    def on_power_batch(self, times: np.ndarray, totals: np.ndarray) -> None:
        if not len(times):
            return
        self._roll_pp()                   # keep the step track chronological
        if not self._have_power:
            self._have_power = True
            self._last_pw = float(totals[0])
        self._pq.append((np.asarray(times, dtype=np.float64),
                         np.asarray(totals, dtype=np.float64)))
        self._pq_n += len(times)
        if self._pq_n >= _VFLUSH:
            self._flush_power()

    def commit_chain(self, nid, times, obs, energy, f_end, c, lam) -> None:
        # Near-O(1) per call: copy the committed slices into a pending
        # batch and do every reduction (sums, late counts, binning) in one
        # big vectorized pass at flush time.  The copies matter — the
        # engine reuses its epoch buffers.
        self.counters["finishes"] += c
        self.counters["launches"] += lam
        self._depth_now[nid] -= float(c)
        self._last_freq[nid] = float(f_end[lam])
        end = float(times[c - 1])
        if end > self._end_t:
            self._end_t = end
        self._ivb.append((nid, times[:c].copy(), obs[:c].copy(),
                          energy[:c].copy()))
        self._ivb_n += c
        if self._ivb_n >= _VFLUSH:
            self._flush_intervals()

    def on_run_end(self, report) -> None:
        self.report = report
        if self._have_power:
            end = max(self._end_t, float(report.makespan_s), self._last_pt)
            self._pp.append((end, self._last_pw))
        self._flush()
        for sub in self._subs:
            sub.on_seal(self, report)

    # --- queries -------------------------------------------------------------
    def edges(self) -> np.ndarray:
        return np.linspace(0.0, self._H, self.bins + 1)

    def power_timeline(self):
        """(bin edges, per-bin mean total draw in watts)."""
        self._need_bound()
        self._flush()
        binw = self._H / self.bins
        integ = self._pA + binw * np.cumsum(self._pC[:self.bins])
        return self.edges(), integ / binw

    def util_timeline(self):
        """(bin edges, (n_nodes, bins) busy fraction per bin)."""
        self._need_bound()
        self._flush()
        binw = self._H / self.bins
        integ = self._uA + binw * np.cumsum(self._uC[:, :self.bins], axis=1)
        return self.edges(), np.clip(integ / binw, 0.0, None)

    def depth_timeline(self):
        """(bin edges, backlog gauge at each bin's end)."""
        self._need_bound()
        self._flush()
        return self.edges(), self.depth0 + np.cumsum(self._depth_bins)

    def rate_timeline(self, kind: str):
        """(bin edges, events/second in each bin) for ``kind`` in
        finish | migrate | crash | shed | reject."""
        self._need_bound()
        self._flush()
        binw = self._H / self.bins
        return self.edges(), self._rates[_RATE_KINDS.index(kind)] / binw

    def tenant_timeline(self, tenant: str):
        """(bin edges, per-bin count of SLO-denying outcomes — rejects plus
        sheds — for one tenant).  Zeros for an unseen tenant."""
        self._need_bound()
        self._flush()
        arr = self._tenant_bins.get(tenant)
        if arr is None:
            arr = np.zeros(self.bins)
        return self.edges(), arr.copy()

    def energy_split(self) -> dict:
        """busy / idle / switch / wire / failed joules.  The idle and
        switch channels need the sealed report (``on_run_end``); before
        that they read 0."""
        self._need_bound()
        rep = self.report
        return {
            "busy_j": float(np.sum(self._energy)),
            "idle_j": float(rep.idle_energy_j) if rep is not None else 0.0,
            "switch_j": (float(rep.switch_energy_j)
                         if rep is not None else 0.0),
            "wire_j": self._mig_energy,
            "failed_j": float(np.sum(self._failed_energy)),
        }

    def snapshot(self) -> dict:
        """Point-in-time aggregate: counters + per-node gauges."""
        self._need_bound()
        self._flush()
        fins = self.counters["finishes"]
        return {
            "counters": dict(self.counters),
            "nodes": {
                nm: {"busy_s": float(self._busy[i]),
                     "energy_j": float(self._energy[i]),
                     "queue_depth": float(self._depth_now[i]),
                     "freq": float(self._last_freq[i])}
                for i, nm in enumerate(self.node_names)},
            "peak_power_w": self.peak_power_w,
            "backlog": float(self._depth_now.sum()),
            "slo_attainment": (1.0 - self.counters["late_blocks"] / fins
                               if fins else 1.0),
            "energy": self.energy_split(),
        }


# --- post-hoc tables (report folds the demos print) --------------------------

def node_rows(report, *, deadline_s: float | None = None) -> list:
    """Per-node table rows off a ``RuntimeReport`` — one dict per node with
    the columns every demo table needs (blocks, in/out, salvage, busy,
    finish, energy, state)."""
    deadline = report.deadline_s if deadline_s is None else deadline_s
    rows = []
    for nr in report.node_reports:
        if nr.crashes and not nr.repairs:
            state = "DOWN"
        elif nr.finish_s <= deadline + 1e-9:
            state = "met"
        else:
            state = "MISS"
        rows.append({
            "node": nr.name, "blocks": nr.n_blocks,
            "in": nr.migrated_in, "out": nr.migrated_out,
            "salvage": nr.salvaged_frac, "busy_s": nr.busy_s,
            "finish_s": nr.finish_s, "energy_j": nr.energy_j,
            "switches": nr.n_switches, "crashes": nr.crashes,
            "down_s": nr.down_s, "state": state,
        })
    return rows


def tenant_rows(sreport) -> list:
    """Per-tenant table rows off a ``ServingReport``."""
    return [{
        "tenant": ts.tenant, "arrived": ts.arrived,
        "accepted": ts.accepted, "rejected": ts.rejected, "shed": ts.shed,
        "finished": ts.finished, "slo_miss": ts.slo_miss,
        "miss_rate": ts.miss_rate,
    } for ts in sreport.tenants]


def format_table(rows, columns, *, indent: str = "    ") -> str:
    """Fixed-width text table.  ``columns`` is a sequence of
    ``(key, header, fmt)`` triples where ``fmt`` is a ``format()`` spec
    (e.g. ``"8.1f"``, ``">6"``); column width is max(header, widest cell).
    """
    cells = [[format(r[k], f) for k, _, f in columns] for r in rows]
    widths = [max(len(h), *(len(c[j]) for c in cells)) if cells else len(h)
              for j, (_, h, _) in enumerate(columns)]
    out = [indent + "  ".join(h.rjust(w) for (_, h, _), w
                              in zip(columns, widths))]
    for c in cells:
        out.append(indent + "  ".join(v.rjust(w) for v, w in zip(c, widths)))
    return "\n".join(out)
