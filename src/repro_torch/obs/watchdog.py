"""SLO burn-rate watchdog: SRE-style multi-window alerts off the metrics.

``Watchdog(rules=...)`` subscribes to a ``StreamingMetrics`` instance
(``attach``; the metrics notify it once, after the final flush — the hot
per-event feeds never pay a callback) and evaluates each rule as a
fast/slow window pair over the metrics' ring-binned timelines: an alert
fires on the bin where BOTH windows' burn rates cross the threshold
(fast window = "it's happening now", slow window = "it's not a blip" —
the classic multi-window burn-rate pattern), and re-arms when the fast
window drops back under.

Signals:

    deadline_risk   blocks-per-second still required to drain the backlog
                    by the deadline, over the achieved finish rate
    energy_burn     windowed mean draw over the budgeted draw
                    (``budget_j / deadline``)
    shed_rate       sheds per second over the budgeted shed rate
    cap_pressure    windowed mean draw over the power cap
    tenant_pressure per-tenant SLO-denying outcomes (rejects + sheds) per
                    second over the tenant's budgeted rate — one alert
                    stream per tenant

Determinism is the point: every input series is either an exact
event-count bin array (order-independent float increments of whole
numbers) or the power step track re-integrated here in one deterministic
pass from ``report.power_samples`` — so the emitted ``Alert`` tuple is
bitwise-identical between the scalar and vector engines and across two
runs.  (Without a full event log the power-based signals fall back to the
metrics' flush-binned power timeline: still deterministic per engine,
identical across engines only in the count-based signals.)

``OnlineReplanner.on_alert`` is the actuation hook: a firing
``deadline_risk`` alert can force the existing replan machinery instead
of waiting for EWMA drift (``Watchdog(..., replanner=ctl)``).

Copied from ``src/repro/obs/watchdog.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Rule", "Alert", "Watchdog", "standard_rules"]

_SIGNALS = ("deadline_risk", "energy_burn", "shed_rate", "cap_pressure",
            "tenant_pressure")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One burn-rate rule: ``signal`` over a fast/slow window pair fires
    when both windowed burn rates reach ``threshold``.  ``budget`` is the
    signal's denominator where one is needed (joules for ``energy_burn``,
    events/second for ``shed_rate`` / ``tenant_pressure``, watts for
    ``cap_pressure`` — defaulting to the run's own cap)."""

    name: str
    signal: str
    fast_s: float
    slow_s: float
    threshold: float = 1.0
    severity: str = "page"
    budget: float | None = None

    def __post_init__(self):
        if self.signal not in _SIGNALS:
            raise ValueError(f"unknown signal {self.signal!r} "
                             f"(pick one of {_SIGNALS})")
        if not (0.0 < self.fast_s <= self.slow_s):
            raise ValueError("need 0 < fast_s <= slow_s")


@dataclasses.dataclass(frozen=True)
class Alert:
    """One deterministic alert record: the rule fired at ``time`` (the
    right edge of the crossing bin) with the fast-window burn ``value``
    and the slow-window burn ``slow_value``."""

    time: float
    rule: str
    signal: str
    window_s: float
    severity: str
    value: float
    slow_value: float
    tenant: str = ""


def standard_rules(deadline_s: float, *, energy_budget_j: float | None = None,
                   power_cap_w: float | None = None,
                   shed_budget_hz: float | None = None,
                   tenant_budget_hz: float | None = None) -> tuple:
    """A reasonable default rule set scaled to the run's deadline: fast
    window = deadline/20, slow = deadline/5.  Signals whose budget is not
    given are omitted (``cap_pressure`` falls back to the run's own cap,
    so it is always included)."""
    fast, slow = deadline_s / 20.0, deadline_s / 5.0
    rules = [Rule("deadline-risk", "deadline_risk", fast, slow,
                  threshold=1.5, severity="page"),
             Rule("cap-pressure", "cap_pressure", fast, slow,
                  threshold=0.95, severity="ticket", budget=power_cap_w)]
    if energy_budget_j is not None:
        rules.append(Rule("energy-burn", "energy_burn", fast, slow,
                          threshold=1.0, severity="ticket",
                          budget=energy_budget_j))
    if shed_budget_hz is not None:
        rules.append(Rule("shed-rate", "shed_rate", fast, slow,
                          threshold=1.0, severity="page",
                          budget=shed_budget_hz))
    if tenant_budget_hz is not None:
        rules.append(Rule("tenant-pressure", "tenant_pressure", fast, slow,
                          threshold=1.0, severity="ticket",
                          budget=tenant_budget_hz))
    return tuple(rules)


def _power_bins_from_samples(samples, H: float, B: int, end: float):
    """Joules per bin off the ledger's step track, one deterministic pass
    (same integral the metrics compute, minus the flush segmentation)."""
    n = len(samples)
    ts = np.fromiter((s[0] for s in samples), np.float64, count=n)
    ws = np.fromiter((s[1] for s in samples), np.float64, count=n)
    xs = np.empty(n + 2)
    xs[0] = 0.0
    xs[1:n + 1] = ts
    xs[n + 1] = max(end, float(ts[-1]))
    vals = np.empty(n + 1)
    vals[0] = ws[0]               # t=0 baseline draw, as the metrics seed it
    vals[1:] = ws
    cum = np.empty(n + 2)
    cum[0] = 0.0
    np.cumsum(np.diff(xs) * vals, out=cum[1:])
    edges = np.linspace(0.0, H, B + 1)
    return np.diff(np.interp(edges, xs, cum))


def _window_sums(counts: np.ndarray, wbins: int):
    """Trailing-window sum ending at each bin (window clipped at t=0)."""
    B = len(counts)
    cs = np.empty(B + 1)
    cs[0] = 0.0
    np.cumsum(counts, out=cs[1:])
    j = np.arange(B) + 1
    return cs[j] - cs[np.maximum(j - wbins, 0)]


class Watchdog:
    """Deterministic burn-rate alerting over a ``StreamingMetrics`` feed.

    ``attach(metrics)`` subscribes; the metrics call ``on_seal`` once the
    run's report is sealed, which evaluates every rule over the full
    timelines and stores the alert stream in ``.alerts``.  ``poll()`` runs
    the same evaluation on demand (mid-run or between runs) and fires the
    callbacks for alerts not yet seen.  ``on_fire(alert)`` is called for
    every new alert; a ``replanner`` (an ``OnlineReplanner``) gets
    ``on_alert(alert)`` for firing ``deadline_risk`` alerts.
    """

    def __init__(self, rules, *, on_fire=None, replanner=None):
        self.rules = tuple(rules)
        self.on_fire = on_fire
        self.replanner = replanner
        self.alerts: tuple = ()
        self.metrics = None
        self.report = None
        self._fired: set = set()

    def attach(self, metrics) -> "Watchdog":
        metrics.subscribe(self)
        self.metrics = metrics
        return self

    # --- subscriber protocol -------------------------------------------------
    def on_seal(self, metrics, report) -> None:
        self.metrics = metrics
        self.report = report
        self.alerts = self.evaluate(metrics, report)
        self._dispatch(self.alerts)

    def poll(self, metrics=None, report=None) -> tuple:
        """Evaluate now; fire callbacks for alerts not already fired."""
        metrics = metrics if metrics is not None else self.metrics
        report = report if report is not None else self.report
        if metrics is None:
            raise RuntimeError("watchdog not attached to a StreamingMetrics")
        alerts = self.evaluate(metrics, report)
        self.alerts = alerts
        self._dispatch(alerts)
        return alerts

    def _dispatch(self, alerts) -> None:
        for a in alerts:
            key = (a.rule, a.tenant, a.time)
            if key in self._fired:
                continue
            self._fired.add(key)
            if self.on_fire is not None:
                self.on_fire(a)
            if self.replanner is not None and a.signal == "deadline_risk":
                self.replanner.on_alert(a)

    # --- evaluation ----------------------------------------------------------
    def evaluate(self, metrics, report=None) -> tuple:
        """The full alert stream for the current timelines, time-ordered
        (then rule order, then tenant) — pure function of the metrics
        state and the report's power track, no side effects."""
        metrics._need_bound()
        metrics._flush()
        B = metrics.bins
        H = metrics._H
        binw = H / B
        edges = np.linspace(0.0, H, B + 1)
        end = float(report.makespan_s) if report is not None \
            else max(metrics._end_t, metrics._last_pt)
        # evaluate through the bin containing the run end
        jmax = min(B, int(math.ceil(end / binw - 1e-12))) if end > 0 else 0

        depth = metrics.depth0 + np.cumsum(metrics._depth_bins)
        fins = metrics._rates[0]
        sheds = metrics._rates[3]
        samples = getattr(report, "runtime", report).power_samples \
            if report is not None else ()
        if samples:
            pj = _power_bins_from_samples(samples, H, B, end)
        else:
            _, watts = metrics.power_timeline()
            pj = watts * binw

        out = []
        for rule in self.rules:
            for tenant, vals in self._burn(rule, metrics, depth, fins,
                                           sheds, pj, binw, edges):
                out.extend(self._scan(rule, vals, edges, jmax, tenant))
        out.sort(key=lambda a: (a.time, self._rule_pos(a.rule), a.tenant))
        return tuple(out)

    def _rule_pos(self, name: str) -> int:
        for i, r in enumerate(self.rules):
            if r.name == name:
                return i
        return len(self.rules)

    def _burn(self, rule, metrics, depth, fins, sheds, pj, binw, edges):
        """Yield ``(tenant, (fast_vals, slow_vals))`` burn series."""
        wf = max(1, int(math.ceil(rule.fast_s / binw - 1e-12)))
        ws = max(1, int(math.ceil(rule.slow_s / binw - 1e-12)))
        B = len(fins)
        j = np.arange(B) + 1
        secs_f = np.minimum(j, wf) * binw
        secs_s = np.minimum(j, ws) * binw

        if rule.signal == "deadline_risk":
            t_right = edges[1:]
            t_left = np.maximum(metrics.deadline_s - t_right, binw)
            required = np.maximum(depth, 0.0) / t_left
            # achieved finish rate, floored at one finish per window so a
            # cold start reads "required × window" instead of infinity
            ach_f = np.maximum(_window_sums(fins, wf), 1.0) / secs_f
            ach_s = np.maximum(_window_sums(fins, ws), 1.0) / secs_s
            yield "", (required / ach_f, required / ach_s)
        elif rule.signal == "energy_burn":
            if rule.budget is None:
                return
            bw = rule.budget / metrics.deadline_s    # budgeted watts
            yield "", (_window_sums(pj, wf) / secs_f / bw,
                       _window_sums(pj, ws) / secs_s / bw)
        elif rule.signal == "shed_rate":
            if rule.budget is None:
                return
            yield "", (_window_sums(sheds, wf) / secs_f / rule.budget,
                       _window_sums(sheds, ws) / secs_s / rule.budget)
        elif rule.signal == "cap_pressure":
            cap = rule.budget if rule.budget is not None \
                else metrics.power_cap_w
            if cap is None:
                return
            yield "", (_window_sums(pj, wf) / secs_f / cap,
                       _window_sums(pj, ws) / secs_s / cap)
        else:  # tenant_pressure
            budget = rule.budget if rule.budget is not None else 1.0
            for tenant in sorted(metrics._tenant_bins):
                c = metrics._tenant_bins[tenant]
                yield tenant, (_window_sums(c, wf) / secs_f / budget,
                               _window_sums(c, ws) / secs_s / budget)

    def _scan(self, rule, vals, edges, jmax, tenant) -> list:
        """Rising-edge state machine: fire when both windows cross, re-arm
        when the fast window drops back under."""
        fast_v, slow_v = vals
        out = []
        firing = False
        for j in range(jmax):
            f = float(fast_v[j])
            s = float(slow_v[j])
            if not firing and f >= rule.threshold and s >= rule.threshold:
                firing = True
                out.append(Alert(
                    time=float(edges[j + 1]), rule=rule.name,
                    signal=rule.signal, window_s=rule.fast_s,
                    severity=rule.severity, value=f, slow_value=s,
                    tenant=tenant))
            elif firing and f < rule.threshold:
                firing = False
        return out
