"""Telemetry-driven calibration: close the estimate->plan->measure loop.

The paper's premise is that DV-DVFS *estimates* processing time and the
frequency needed to meet the deadline before actuating — but the repo's
estimates rested on constructed constants (``TPU_V5E_POWER``, fixed
``NodeSpec.speed``), so on any hardware that deviates the planner was
confidently wrong.  This package learns those models from measured counter
traces instead:

  trace   ``CounterTrace`` — per-interval ``(t, dur_s, node, freq, util,
          energy_j, work_done)`` samples (the shape RAPL / TPU telemetry
          windows deliver); ``TraceRecorder`` is the sink the runtime
          engine emits into natively (``RuntimeConfig(trace=...)``, one
          sample per executed block segment).
  fit     ``fit_power_model`` (vectorized grid + closed-form weighted LS
          jointly recovering ``p_idle/p_full/alpha``), ``fit_cost_model``
          (per-app record cost + roofline memory-bound fraction), and
          ``fit_node_speeds`` (effective relative speeds).
          ``calibrate_nodes`` bundles them: ``NodeSpec``s in,
          ``CalibratedNodeSpec``s out — also reachable as
          ``plan_cluster(..., calibration=trace)``.
  online  ``OnlineCalibrator`` — sliding-window refits + change detection;
          plugged into ``OnlineReplanner`` (``RuntimeConfig(online=True,
          calibrator=...)``) it swaps a node's spec mid-run and re-plans
          the tail against recalibrated tables, not just EWMA-drifted
          estimates.
  triage  ``classify_ratios`` — drift-CAUSE classification over a node's
          observed/predicted ratio stream (interference vs degrading
          hardware vs data skew); feeds the crash-recovery ladder's
          never-wait-on-a-dying-node rule
          (``repro.runtime.recovery.RecoveryPolicy(use_triage=True)``).

See ``benchmarks/README.md`` (section ``calibrate``) for the fit-accuracy
grid and the calibrated-vs-default planning comparison, and
``examples/calibrate.py`` for the loop end to end.

Copied from ``src/repro/calibrate/__init__.py`` with its imports pointed at ``repro_torch``.
It is NumPy, as the original is, so its results are bit-identical to the
reference's.
"""
from repro_torch.calibrate.fit import (CalibrationError, CostFit, PowerFit,
                                 SpeedFit, calibrate_nodes, fit_cost_model,
                                 fit_node_speeds, fit_power_model)
from repro_torch.calibrate.online import OnlineCalibrator
from repro_torch.calibrate.trace import (CounterSample, CounterTrace,
                                   TraceRecorder, synthetic_trace)
from repro_torch.calibrate.triage import DriftDiagnosis, classify_ratios

__all__ = [
    "CounterSample", "CounterTrace", "TraceRecorder", "synthetic_trace",
    "CalibrationError", "PowerFit", "CostFit", "SpeedFit",
    "fit_power_model", "fit_cost_model", "fit_node_speeds",
    "calibrate_nodes",
    "OnlineCalibrator",
    "DriftDiagnosis", "classify_ratios",
]
