"""Online calibration: windowed refits + change detection over a live trace.

``OnlineCalibrator`` wraps the batch fitters (``repro.calibrate.fit``) for
the estimate->plan->measure loop: the runtime engine feeds it the counter
samples its actuator path emits (one per executed block segment), and the
calibrator refits the node's speed and power model over a sliding window.
When a refit moves the model beyond a relative threshold, ``add`` returns
True and ``OnlineReplanner._apply_calibration`` swaps the node's spec for a
``CalibratedNodeSpec`` and re-plans the tail against the *recalibrated*
tables — a structurally better correction than the EWMA drift scalar, which
can only stretch every estimate by one factor.

Everything is deterministic: fixed windows, closed-form fits, no RNG —
two identical runs recalibrate identically (asserted by
``tests/test_calibrate.py``).

Copied from ``src/repro/calibrate/online.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

from repro_torch.calibrate.fit import (CalibrationError, PowerFit, SpeedFit,
                                 fit_node_speeds, fit_power_model)
from repro_torch.calibrate.trace import CounterSample, CounterTrace

__all__ = ["OnlineCalibrator"]


class _NodeWindow:
    __slots__ = ("samples", "since_refit", "power_fit", "speed_fit")

    def __init__(self):
        self.samples: list = []        # sliding window of CounterSample
        self.since_refit = 0
        self.power_fit: PowerFit | None = None   # last APPLIED fits
        self.speed_fit: SpeedFit | None = None


class OnlineCalibrator:
    """Sliding-window refits with change detection, per node.

    Parameters:
      window:        samples retained per node (refits see only these).
      min_samples:   no refit below this many samples — the first
                     observations ride on the constructed defaults.
      refit_every:   refit cadence, in new samples per node.
      rel_threshold: relative model change that triggers re-application —
                     compared on the fitted speed and on predicted power
                     over the window's own operating points, so an alpha/
                     p_idle trade-off that predicts the same powers does
                     not thrash the planner.
    """

    def __init__(self, *, window: int = 64, min_samples: int = 6,
                 refit_every: int = 4, rel_threshold: float = 0.05):
        if window < 2 or min_samples < 2 or refit_every < 1:
            raise ValueError("window/min_samples >= 2, refit_every >= 1")
        self.window = window
        self.min_samples = min_samples
        self.refit_every = refit_every
        self.rel_threshold = rel_threshold
        self._nodes: dict = {}
        self.n_refits = 0
        self.n_changes = 0

    def _win(self, node: str) -> _NodeWindow:
        w = self._nodes.get(node)
        if w is None:
            w = self._nodes[node] = _NodeWindow()
        return w

    # --- ingestion -----------------------------------------------------------
    def add(self, sample: CounterSample) -> bool:
        """Ingest one sample; True when the node's model changed enough
        that plans built from the previous model are stale.

        Zero-length intervals (``dur_s == 0``) are accepted and retained —
        the fitters drop them — so a degenerate segment can never divide by
        zero or poison a window.
        """
        w = self._win(sample.node)
        w.samples.append(sample)
        if len(w.samples) > self.window:
            del w.samples[:len(w.samples) - self.window]
        w.since_refit += 1
        if len(w.samples) < self.min_samples \
                or w.since_refit < self.refit_every:
            return False
        w.since_refit = 0
        return self._refit(sample.node, w)

    def extend(self, samples) -> bool:
        changed = False
        for s in samples:
            changed = self.add(s) or changed
        return changed

    # --- refit + change detection --------------------------------------------
    def _refit(self, node: str, w: _NodeWindow) -> bool:
        self.n_refits += 1
        tr = CounterTrace.from_samples(w.samples)
        try:
            speed = fit_node_speeds(tr)[node]
        except (CalibrationError, KeyError):
            speed = None
        try:
            power = fit_power_model(tr, node=node)
        except CalibrationError:
            power = None    # window can't identify the family: keep the old
        changed = False
        if speed is not None and self._speed_changed(w.speed_fit, speed):
            w.speed_fit = speed
            changed = True
        if power is not None and self._power_changed(w.power_fit, power, tr):
            w.power_fit = power
            changed = True
        self.n_changes += int(changed)
        return changed

    def _speed_changed(self, old: SpeedFit | None, new: SpeedFit) -> bool:
        if old is None:
            return True
        return abs(new.speed / max(old.speed, 1e-12) - 1.0) \
            > self.rel_threshold

    def _power_changed(self, old: PowerFit | None, new: PowerFit,
                       tr: CounterTrace) -> bool:
        if old is None:
            return True
        om, nm = old.to_power_model(), new.to_power_model()
        keep = tr.dur_s > 0
        rel = 0.0
        for u, f in zip(tr.util[keep].tolist(), tr.freq[keep].tolist()):
            po = om.power(u, f)
            rel = max(rel, abs(nm.power(u, f) / max(po, 1e-12) - 1.0))
        return rel > self.rel_threshold

    # --- what the controller consumes ----------------------------------------
    def power_fit(self, node: str) -> PowerFit | None:
        w = self._nodes.get(node)
        return w.power_fit if w else None

    def speed_fit(self, node: str) -> SpeedFit | None:
        w = self._nodes.get(node)
        return w.speed_fit if w else None

    def calibrated_spec(self, node: str, spec):
        """``spec`` upgraded with this node's currently-applied fits (the
        spec itself when nothing has been fitted yet)."""
        from repro_torch.cluster.node import CalibratedNodeSpec
        w = self._nodes.get(node)
        if w is None or (w.power_fit is None and w.speed_fit is None):
            return spec
        return CalibratedNodeSpec(
            name=spec.name,
            speed=w.speed_fit.speed if w.speed_fit else spec.speed,
            ladder=spec.ladder,
            power=(w.power_fit.to_power_model() if w.power_fit
                   else spec.power),
            power_fit=w.power_fit, speed_fit=w.speed_fit)
