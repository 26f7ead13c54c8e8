"""Drift-cause triage: WHY is a node slower than its plan said?

The online controller tracks one number per node — the EWMA of
observed/predicted time ratios — and treats every excursion the same way:
re-plan the tail, maybe migrate.  But the paper's energy argument cuts
differently depending on the *cause* of the drift, and the ratio STREAM
(not just its mean) carries enough shape to tell the common causes apart:

  interference   co-located work steals cycles: the ratio steps up to a
                 roughly constant level and sits there.  Uniform mean
                 shift, no trend, low dispersion.  Waiting it out or
                 re-clocking is reasonable; the node is healthy.
  degrading      thermal throttling or dying hardware: the ratio climbs
                 block over block.  Significant positive trend.  Never
                 wait on such a node, never evacuate work onto it — it
                 will be slower tomorrow than today.
  data_skew      the estimates are wrong, not the node: per-block cost
                 variety (the DV in DV-DVFS) that the planner's bands did
                 not capture.  High residual dispersion around a flat
                 level — some blocks fast, some slow, no persistent
                 direction.  The fix is calibration/re-planning, not
                 hardware suspicion.

``classify_ratios`` is deliberately tiny and closed-form (least-squares
slope + residual moments over the log-ratio stream) so the recovery
ladder can call it at crash time without a fit budget.  Priority when
signals co-occur: trend beats dispersion beats shift — a degrading node
also shows a shifted mean, but the trend is the actionable part.

Wired in via ``OnlineReplanner(track_ratios=True)`` (kept automatically
when ``RecoveryPolicy(use_triage=True)``) and surfaced as
``OnlineReplanner.diagnose(node)``.

Copied from ``src/repro/calibrate/triage.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["DriftDiagnosis", "classify_ratios"]


@dataclasses.dataclass(frozen=True)
class DriftDiagnosis:
    """Outcome of one triage pass over a node's ratio log.

    cause:      "none" | "interference" | "degrading" | "data_skew"
    severity:   how far the mean log-ratio sits from 0 (geometric mean
                observed/predicted; ~0.1 == ~10% slow)
    trend:      fitted log-ratio slope per observation (positive == the
                node keeps getting slower)
    dispersion: residual standard deviation around the trend line (block-
                to-block scatter the estimates failed to price)
    n:          observations the verdict rests on
    """

    cause: str
    severity: float
    trend: float
    dispersion: float
    n: int


def classify_ratios(ratios, *, min_n: int = 6, shift_thresh: float = 0.08,
                    trend_sig: float = 3.0, skew_thresh: float = 0.25
                    ) -> DriftDiagnosis:
    """Classify a node's observed/predicted ratio stream (see module doc).

    ``min_n`` observations are required for any verdict (below it the
    cause is ``"none"`` — insufficient evidence, not health).  Thresholds:
    ``shift_thresh`` is the mean log-ratio past which a flat stream counts
    as interference; ``trend_sig`` is the t-statistic the LS slope must
    clear to count as degrading (slope / its standard error — scale-free,
    so short noisy logs don't cry wolf); ``skew_thresh`` is the residual
    standard deviation past which scatter counts as data skew.
    """
    vals = [math.log(max(float(r), 1e-12)) for r in ratios]
    n = len(vals)
    if n < min_n:
        mean = sum(vals) / n if n else 0.0
        return DriftDiagnosis("none", mean, 0.0, 0.0, n)
    mean = sum(vals) / n
    # closed-form LS slope of log-ratio against observation number
    xm = (n - 1) / 2.0
    sxx = sum((i - xm) ** 2 for i in range(n))
    sxy = sum((i - xm) * (v - mean) for i, v in enumerate(vals))
    slope = sxy / sxx
    resid = [v - mean - slope * (i - xm) for i, v in enumerate(vals)]
    dof = max(n - 2, 1)
    s2 = sum(r * r for r in resid) / dof
    dispersion = math.sqrt(s2)
    # slope t-statistic: se(slope) = sqrt(s2 / sxx)
    se = math.sqrt(s2 / sxx) if s2 > 0 else 0.0
    t_stat = slope / se if se > 0 else (math.inf if slope > 0 else 0.0)
    if slope > 0 and t_stat >= trend_sig:
        cause = "degrading"
    elif dispersion >= skew_thresh:
        cause = "data_skew"
    elif abs(mean) >= shift_thresh:
        cause = "interference"
    else:
        cause = "none"
    return DriftDiagnosis(cause, mean, slope, dispersion, n)
