"""Counterfactual replay: what did each mechanism buy on THIS run.

The paper's argument is differential — DV-DVFS vs the f_max baseline vs
naive planners — and the runtime's bitwise-deterministic scalar/vector
engines make exact counterfactuals cheap: replay the identical scenario
with exactly ONE mechanism neutralized and every joule and second of
delta is causally attributable to that mechanism, with zero statistical
noise.

``Scenario`` captures a replayable run configuration (plan, truth,
config, events, optional serving traffic).  ``neutralize(scenario,
mechanism)`` returns the scenario with one mechanism turned off:

    dvfs        every node pinned at f_max — the plan is re-priced on a
                single-state ladder, so online replans stay pinned too
                (the paper's own baseline comparison)
    migration   work stealing off (``migrate=False``)
    power_cap   cap lifted (``power_cap_w=None``)
    admission   serving admission AND shedding off (serving scenarios)
    recovery    crash recovery policy dropped
    actuation   free instantaneous frequency switches
    calibration online model refit frozen at defaults

``ablate`` runs the neutralized scenario (fanning out over both engines
and asserting report identity as a free cross-check), and
``profile_mechanisms`` produces the per-mechanism ledger: Δenergy per
channel (busy / idle / switch / wire / failed), Δdeadline-slack, Δmisses,
and Δper-tenant SLO.  ``delta_ledger`` guarantees the reconciliation is
*exact*: ``math.fsum`` of the five channel deltas plus the rational-space
residual equals the difference of the two reports' own channel totals
bitwise (same ulp-nudging as ``explain_energy``).

Copied from ``src/repro/obs/counterfactual.py`` with its imports pointed at
``repro_torch``. It is NumPy, as the original is, so its results are bit-
identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.energy import FrequencyLadder
from repro_torch.core.scheduler import plan_dvfs_arrays
from repro_torch.core.soa import BlockArrays
from repro_torch.obs.explain import _exact_residual
from repro_torch.runtime.actuator import ActuationModel
from repro_torch.runtime.engine import run_cluster

__all__ = ["MECHANISMS", "Scenario", "neutralize", "ablate",
           "delta_ledger", "profile_mechanisms", "mechanism_columns"]

MECHANISMS = ("dvfs", "migration", "power_cap", "admission", "recovery",
              "actuation", "calibration")

_PIN_LADDER = FrequencyLadder((1.0,))

_CHANNELS = ("busy_j", "idle_j", "switch_j", "wire_j", "failed_j")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A replayable run: everything ``run_cluster`` / ``run_serving``
    needs, captured so the identical scenario can be re-run with a
    mechanism ablated.

    The config must be STATELESS (``metrics`` / ``trace`` / ``calibrator``
    unset) — each replay gets its own sinks.  A calibrated scenario passes
    ``calibrator_factory`` (a zero-arg callable) instead of a calibrator
    instance; neutralizing ``calibration`` drops the factory.
    """

    plan: object                       # ClusterPlan(Arrays)
    truth: object                      # BlockArrays | Sequence[BlockInfo]
    config: object                     # RuntimeConfig
    events: tuple = ()
    est_blocks: object = None
    true_nodes: object = None
    arrivals: object = None            # ArrivalSpec | schedule -> serving run
    serving: object = None             # ServingConfig (serving runs only)
    arrival_truth: float = 1.0
    calibrator_factory: object = None  # () -> OnlineCalibrator | None

    def __post_init__(self):
        for field in ("metrics", "trace", "calibrator"):
            if getattr(self.config, field, None) is not None:
                raise ValueError(
                    f"Scenario.config.{field} must be None — replay runs "
                    "the scenario several times and stateful sinks feed "
                    "exactly one run (pass calibrator_factory= for a "
                    "calibrated scenario; pass metrics per run instead)")

    @property
    def is_serving(self) -> bool:
        return self.arrivals is not None

    def run(self, *, engine: str = "auto", metrics=None):
        """One replay.  Returns a ``RuntimeReport`` (batch) or a
        ``ServingReport`` (when the scenario carries arrivals)."""
        kw = {}
        if metrics is not None:
            kw["metrics"] = metrics
        if self.calibrator_factory is not None:
            kw["calibrator"] = self.calibrator_factory()
        cfg = dataclasses.replace(self.config, **kw) if kw else self.config
        if self.is_serving:
            from repro_torch.serving.fabric import ServingConfig, run_serving
            return run_serving(
                self.plan, self.truth, self.arrivals, config=cfg,
                serving=self.serving or ServingConfig(),
                arrival_truth=self.arrival_truth, events=self.events,
                est_blocks=self.est_blocks, true_nodes=self.true_nodes,
                engine=engine)
        return run_cluster(self.plan, self.truth, config=cfg,
                           events=self.events, est_blocks=self.est_blocks,
                           true_nodes=self.true_nodes, engine=engine)


def _est_arrays(scenario) -> BlockArrays:
    est = scenario.est_blocks if scenario.est_blocks is not None \
        else scenario.truth
    return est if isinstance(est, BlockArrays) \
        else BlockArrays.from_blocks(est)


def _pin_fmax(scenario: Scenario) -> Scenario | None:
    """Re-price the plan on a single-state f_max ladder per node.

    The assignment (which blocks on which node, in which order) is kept;
    each node's share is re-planned against ``FrequencyLadder((1.0,))`` so
    the initial frequencies AND every online replan stay pinned — the
    controller replans off ``spec.ladder``, which the pinned ``NodeSpec``
    carries.  Returns None when the scenario is already DVFS-free.
    """
    from repro_torch.cluster.planner import ClusterPlanArrays, NodePlanArrays

    cpa = scenario.plan.to_arrays()
    if all(npa.node.ladder.states == (1.0,) for npa in cpa.node_plans):
        return None
    ba = _est_arrays(scenario)
    order = np.argsort(ba.index, kind="stable")
    sorted_idx = ba.index[order]
    node_plans = []
    for npa in cpa.node_plans:
        spec = dataclasses.replace(npa.node, ladder=_PIN_LADDER)
        pos = order[np.searchsorted(sorted_idx, npa.plan.index)]
        local = BlockArrays(
            npa.plan.index.copy(),
            ba.est_time_fmax[pos] / spec.speed,
            ba.est_rel_halfwidth[pos], ba.util[pos],
            ba.roofline.select(pos) if ba.roofline is not None else None,
            None)
        # "global" regardless of the original planner: with one ladder
        # state the frequency choice is forced, and the online controller
        # replans with "global" too
        pinned = plan_dvfs_arrays(
            local, cpa.deadline_s, planner="global",
            ladder=_PIN_LADDER, power=spec.power,
            error_margin=scenario.config.error_margin)
        node_plans.append(NodePlanArrays(spec, pinned))
    plan = ClusterPlanArrays(cpa.planner, cpa.deadline_s, tuple(node_plans),
                             cpa.feasible, cpa.power_cap_ok)
    return dataclasses.replace(scenario, plan=plan)


def neutralize(scenario: Scenario, mechanism: str) -> tuple:
    """``(scenario', changed)`` with exactly ``mechanism`` turned off.

    ``changed`` is False when the mechanism was already inactive (the
    ablation is then an identity replay and every delta is exactly zero).
    """
    if mechanism not in MECHANISMS:
        raise ValueError(f"unknown mechanism {mechanism!r} "
                         f"(pick one of {MECHANISMS})")
    cfg = scenario.config
    if mechanism == "dvfs":
        pinned = _pin_fmax(scenario)
        return (scenario, False) if pinned is None else (pinned, True)
    if mechanism == "migration":
        if not cfg.migrate:
            return scenario, False
        return dataclasses.replace(
            scenario, config=dataclasses.replace(cfg, migrate=False)), True
    if mechanism == "power_cap":
        if cfg.power_cap_w is None:
            return scenario, False
        return dataclasses.replace(
            scenario,
            config=dataclasses.replace(cfg, power_cap_w=None)), True
    if mechanism == "admission":
        sv = scenario.serving
        if not scenario.is_serving or sv is None \
                or not (sv.admission or sv.shedding):
            return scenario, False
        return dataclasses.replace(
            scenario, serving=dataclasses.replace(
                sv, admission=False, shedding=False)), True
    if mechanism == "recovery":
        if cfg.recovery is None:
            return scenario, False
        return dataclasses.replace(
            scenario, config=dataclasses.replace(cfg, recovery=None)), True
    if mechanism == "actuation":
        free = ActuationModel(latency_s=0.0, switch_energy_j=0.0)
        if cfg.actuation == free:
            return scenario, False
        return dataclasses.replace(
            scenario, config=dataclasses.replace(cfg, actuation=free)), True
    # calibration
    if scenario.calibrator_factory is None:
        return scenario, False
    return dataclasses.replace(scenario, calibrator_factory=None), True


def _run_identical(scenario, engines) -> object:
    """Run on every engine in ``engines`` and assert the reports AND event
    logs agree — the determinism contract gives the cross-check for free."""
    engines = tuple(engines)
    first = scenario.run(engine=engines[0])
    for eng in engines[1:]:
        other = scenario.run(engine=eng)
        if other != first:
            raise AssertionError(
                f"engine divergence on counterfactual replay: "
                f"{engines[0]!r} vs {eng!r} disagree")
    return first


def ablate(scenario: Scenario, mechanism: str, *,
           engines=("vector",)) -> object:
    """Re-run ``scenario`` with ``mechanism`` neutralized.  With more than
    one engine listed the replay fans out and asserts report identity."""
    neutral, _ = neutralize(scenario, mechanism)
    return _run_identical(neutral, engines)


def _channels(report) -> dict:
    rt = getattr(report, "runtime", report)
    return {"busy_j": rt.total_energy_j, "idle_j": rt.idle_energy_j,
            "switch_j": rt.switch_energy_j, "wire_j": rt.migration_energy_j,
            "failed_j": rt.failed_energy_j}


def _misses(report) -> int:
    rt = getattr(report, "runtime", report)
    n = len(rt.missed_blocks) + (0 if rt.deadline_met else 1)
    if hasattr(report, "tenants"):
        n += sum(ts.slo_miss for ts in report.tenants)
    return n


def delta_ledger(base, other) -> dict:
    """Exact per-channel energy delta of ``other`` minus ``base``.

    ``d_total_j`` is the difference of the two reports' own totals
    (``fsum`` of each report's five channels, as ``explain_energy``
    defines them) and ``residual_j`` is ulp-nudged so that
    ``math.fsum([d_busy_j, d_idle_j, d_switch_j, d_wire_j, d_failed_j,
    residual_j]) == d_total_j`` holds BITWISE.
    """
    cb, co = _channels(base), _channels(other)
    out = {"d_" + k: co[k] - cb[k] for k in _CHANNELS}
    total_b = math.fsum(cb.values())
    total_o = math.fsum(co.values())
    d_total = total_o - total_b
    out["residual_j"] = _exact_residual(
        d_total, [out["d_" + k] for k in _CHANNELS])
    out["d_total_j"] = d_total
    out["base_total_j"] = total_b
    rb = getattr(base, "runtime", base)
    ro = getattr(other, "runtime", other)
    out["d_slack_s"] = (ro.deadline_s - ro.makespan_s) \
        - (rb.deadline_s - rb.makespan_s)
    out["d_misses"] = _misses(other) - _misses(base)
    return out


def _tenant_deltas(base, other) -> dict:
    """Per-tenant SLO deltas (serving reports only; {} otherwise)."""
    if not (hasattr(base, "tenants") and hasattr(other, "tenants")):
        return {}
    tb = {ts.tenant: ts for ts in base.tenants}
    to = {ts.tenant: ts for ts in other.tenants}
    out = {}
    for name in sorted(set(tb) | set(to)):
        b, o = tb.get(name), to.get(name)

        def g(ts, field):
            return getattr(ts, field) if ts is not None else 0

        row = {"d_slo_miss": g(o, "slo_miss") - g(b, "slo_miss"),
               "d_shed": g(o, "shed") - g(b, "shed"),
               "d_rejected": g(o, "rejected") - g(b, "rejected"),
               "d_finished": g(o, "finished") - g(b, "finished"),
               "d_miss_rate": g(o, "miss_rate") - g(b, "miss_rate")}
        if any(row.values()):
            out[name] = row
    return out


def profile_mechanisms(scenario: Scenario, *, mechanisms=None,
                       engines=("vector", "scalar"), base=None) -> list:
    """Per-mechanism counterfactual ledger for one scenario.

    Runs the base scenario once and each mechanism's ablation once, every
    run fanned over ``engines`` with report identity asserted.  Returns
    one row dict per mechanism — ``format_table(rows,
    mechanism_columns())`` prints it — where a positive ``d_*`` means the
    ablated run pays MORE (the mechanism was saving that much).
    """
    if mechanisms is None:
        mechanisms = [m for m in MECHANISMS
                      if m != "admission" or scenario.is_serving]
    if base is None:
        base = _run_identical(scenario, engines)
    rows = []
    for mech in mechanisms:
        neutral, changed = neutralize(scenario, mech)
        rep = _run_identical(neutral, engines) if changed else base
        row = {"mechanism": mech, "changed": changed}
        row.update(delta_ledger(base, rep))
        row["tenants"] = _tenant_deltas(base, rep)
        assert math.fsum([row["d_" + k] for k in _CHANNELS]
                         + [row["residual_j"]]) == row["d_total_j"]
        if not changed:
            assert row["d_total_j"] == 0.0 and row["d_misses"] == 0
        rows.append(row)
    return rows


def mechanism_columns() -> tuple:
    """``format_table`` columns for ``profile_mechanisms`` rows."""
    return (("mechanism", "mechanism", ""),
            ("d_busy_j", "d_busy_j", "+10.1f"),
            ("d_idle_j", "d_idle_j", "+10.1f"),
            ("d_switch_j", "d_switch_j", "+8.2f"),
            ("d_wire_j", "d_wire_j", "+8.2f"),
            ("d_failed_j", "d_failed_j", "+8.2f"),
            ("d_total_j", "d_total_j", "+10.1f"),
            ("d_slack_s", "d_slack_s", "+8.3f"),
            ("d_misses", "d_misses", "+d"))
