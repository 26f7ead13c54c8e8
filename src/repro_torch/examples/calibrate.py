"""Close the estimate->plan->measure loop on mis-modeled hardware.

The planner ships with constructed constants (``TPU_V5E_POWER``, NodeSpec
speed 1.0).  Here the actual machines deviate: one node is 25% slower, one
30% faster, and every chip follows a different power curve.  The demo:

  1  plan with the DEFAULT constants and run on the true hardware
     (``run_cluster(..., true_nodes=...)``), recording the counter trace
     the engine's actuator path emits natively;
  2  fit power models + effective speeds from the trace
     (``repro_torch.calibrate``) and re-plan against the calibrated specs;
  3  re-run: the calibrated plan meets the deadline the default plan
     missed, at lower busy energy.

Run: PYTHONPATH=src python -m repro_torch.examples.calibrate

Copied from ``examples/calibrate.py`` with its imports pointed at
``repro_torch``: NumPy only, so it prints the reference's text.  ``main``
also returns the two runs' reports.
"""
import numpy as np

from repro_torch.calibrate import TraceRecorder, calibrate_nodes
from repro_torch.cluster import NodeSpec, plan_cluster
from repro_torch.core import BlockInfo, FrequencyLadder
from repro_torch.core.energy import PowerModel
from repro_torch.runtime import RuntimeConfig, run_cluster

DEEP = FrequencyLadder(
    states=tuple(round(f, 2) for f in np.arange(0.35, 1.001, 0.05)))


def main() -> dict:
    rng = np.random.default_rng(0)
    n = 60
    blocks = [BlockInfo(i, float(c), util=float(u)) for i, (c, u) in
              enumerate(zip(rng.lognormal(1.0, 0.5, n),
                            rng.uniform(0.6, 1.0, n)))]

    # what the planner BELIEVES vs what the machines ARE
    believed = [NodeSpec(f"n{k}", speed=1.0, ladder=DEEP) for k in range(3)]
    true = [NodeSpec("n0", speed=0.75, ladder=DEEP,
                     power=PowerModel(p_full=240.0, p_idle=85.0, alpha=1.9)),
            NodeSpec("n1", speed=1.30, ladder=DEEP,
                     power=PowerModel(p_full=180.0, p_idle=55.0, alpha=2.9)),
            NodeSpec("n2", speed=1.10, ladder=DEEP,
                     power=PowerModel(p_full=210.0, p_idle=65.0, alpha=2.4))]
    deadline = sum(b.est_time_fmax for b in blocks) / 3 * 1.6

    # 1: plan on defaults, run on truth, record the counter trace
    plan_def = plan_cluster(blocks, believed, deadline, assignment="lpt")
    recorder = TraceRecorder()
    rep_def = run_cluster(plan_def, blocks,
                          config=RuntimeConfig(trace=recorder,
                                               log_events=False),
                          true_nodes=true)
    trace = recorder.trace()
    print(f"recorded {len(trace)} counter samples "
          f"({len(trace.node_names())} nodes)\n")

    # 2: fit and re-plan
    calibrated = calibrate_nodes(believed, trace)
    print(f"{'node':<5} {'fitted speed':>12} {'true':>6}   "
          f"{'fitted power (idle/full/alpha)':>30}   true")
    for nd, t in zip(calibrated, true):
        print(f"{nd.name:<5} {nd.speed:>12.4f} {t.speed:>6.2f}   "
              f"{nd.power.p_idle:>8.1f}/{nd.power.p_full:.1f}/"
              f"{nd.power.alpha:.2f}{'':>6}   "
              f"{t.power.p_idle:.1f}/{t.power.p_full:.1f}/"
              f"{t.power.alpha:.2f}")
    plan_cal = plan_cluster(blocks, calibrated, deadline, assignment="lpt")

    # 3: re-run on the same truth
    rep_cal = run_cluster(plan_cal, blocks,
                          config=RuntimeConfig(log_events=False),
                          true_nodes=true)

    print(f"\n{'plan':<12} {'deadline':>9} {'makespan':>9} {'met':>5} "
          f"{'busy energy':>12}")
    for tag, rep in (("default", rep_def), ("calibrated", rep_cal)):
        print(f"{tag:<12} {rep.deadline_s:>9.1f} {rep.makespan_s:>9.1f} "
              f"{str(rep.deadline_met):>5} {rep.total_energy_j:>10.0f} J")
    imp = rep_cal.improvement_vs(rep_def)
    print(f"\ncalibrated vs default: busy energy {imp:+.1%}, "
          f"deadline {'recovered' if rep_cal.deadline_met and not rep_def.deadline_met else 'kept'}")
    return {"default": rep_def, "calibrated": rep_cal}


if __name__ == "__main__":
    main()
