"""The port's copied event-driven runtime is bit-identical to the reference.

``repro_torch.runtime`` is a NumPy copy, not an import, of the reference
package; the same seeded plans, truths, events and configs must give the
same ``RuntimeReport`` and the same event log, field by field, through both
engines: faults (time-based and block-count), node failures with a
``RecoveryPolicy`` and checkpoint salvage, non-zero actuation, migration
with wire costs, a cluster power cap, a ``TraceRecorder`` sink with an
``OnlineCalibrator``, and every ``event_log`` mode.  The seeded chaos
harness (``chaos_scenario``, ``run_campaign``) agrees too.
"""
import dataclasses

import numpy as np
import pytest

import repro.calibrate as rcal
import repro.cluster as rcl
import repro.core as rc
import repro.runtime as rrt
import repro.runtime.failures as rfail
import repro_torch.calibrate as tcal
import repro_torch.cluster as tcl
import repro_torch.core as tc
import repro_torch.runtime as trt
import repro_torch.runtime.failures as tfail
from test_torch_cluster import _same

SEEDS = [0, 1, 2]
ENGINES = ["scalar", "vector"]
PKG = {"ref": (rc, rcl, rcal, rrt), "port": (tc, tcl, tcal, trt)}
# which features a scenario switches on
KINDS = {
    "plain": set(),
    "faults": {"faults"},
    "actuation": {"actuation"},
    "migrate": {"migrate"},
    "cap": {"cap"},
    "failures": {"failures"},
    "trace": {"trace"},
    "everything": {"faults", "actuation", "migrate", "cap", "failures",
                   "trace"},
}


def _scenario(pkg, seed, features, event_log="full"):
    """Seeded plan, truth, estimates, events and a fresh config of ``pkg``."""
    core, cl, cal, rt = PKG[pkg]
    rng = np.random.default_rng(seed)
    n, k = 48, 4
    blocks = []
    for i in range(n):
        est = float(rng.uniform(0.2, 3.0))
        roof = None
        if rng.random() < 0.3:
            roof = core.RooflineTimeModel(core.RooflineTerms(
                t_comp=est * float(rng.uniform(0.3, 0.8)),
                t_mem=est * float(rng.uniform(0.1, 0.5)),
                t_coll=0.0, t_fixed=est * float(rng.uniform(0, 0.2))))
        blocks.append(core.BlockInfo(
            i, est, est_rel_halfwidth=float(rng.uniform(0, 0.2)),
            util=float(rng.uniform(0.4, 1.0)), roofline=roof,
            records=float(rng.integers(50, 4000))))
    ladder = core.FrequencyLadder((0.5, 0.7, 0.85, 1.0))
    nodes = [cl.NodeSpec(f"n{j}", ladder=ladder, speed=float(s),
                         power=core.PowerModel(p_idle=30 + 3 * j,
                                               p_full=120 + 10 * j,
                                               alpha=2.0 + 0.2 * j))
             for j, s in enumerate(rng.uniform(0.7, 1.4, k))]
    deadline = sum(b.est_time_fmax for b in blocks) / k * 1.3
    plan = cl.plan_cluster(blocks, nodes, deadline_s=deadline)
    drift = rng.uniform(0.8, 1.5, n)
    truth = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax * float(d))
             for b, d in zip(blocks, drift)]
    events = []
    if "faults" in features:
        events += [rt.FaultEvent(time=0.3 * deadline, node="n1", factor=1.8),
                   cl.SlowdownEvent("n2", after_block=3, factor=1.5)]
    kw = dict(online=True, event_log=event_log)
    if "actuation" in features:
        kw["actuation"] = rt.ActuationModel(latency_s=0.3,
                                            switch_energy_j=2.0)
    if "migrate" in features:
        kw.update(migrate=True, migration=rt.MigrationModel(
            latency_s_per_block=0.2, energy_j_per_record=0.001))
    if "cap" in features:
        kw["power_cap_w"] = sum(nd.power.p_idle for nd in nodes) \
            + 0.55 * sum(nd.power.p_full - nd.power.p_idle for nd in nodes)
    if "failures" in features:
        events += [rt.NodeFailureEvent(time=0.25 * deadline, node="n0",
                                       repair_s=0.2 * deadline),
                   rt.NodeFailureEvent(time=0.5 * deadline, node="n3",
                                       flavor="permanent")]
        kw["recovery"] = rt.RecoveryPolicy(
            checkpoint=rt.CheckpointModel(interval_s=0.4), use_triage=True)
    if "trace" in features:
        kw.update(trace=cal.TraceRecorder(),
                  calibrator=cal.OnlineCalibrator(window=24, min_samples=12))
    return plan, truth, blocks, events, rt.RuntimeConfig(**kw)


def _run(pkg, seed, features, engine, event_log="full"):
    plan, truth, blocks, events, cfg = _scenario(pkg, seed, features,
                                                 event_log)
    rep = PKG[pkg][3].run_cluster(plan, truth, config=cfg, events=events,
                                  est_blocks=blocks, engine=engine)
    sink = cfg.trace.trace() if cfg.trace is not None else None
    return rep, sink, _calibrator_state(cfg.calibrator)


def _calibrator_state(oc):
    """What an ``OnlineCalibrator`` learned during a run, as plain data."""
    if oc is None:
        return None
    return (oc.n_refits, oc.n_changes,
            {name: (oc.power_fit(name), oc.speed_fit(name))
             for name in sorted(oc._nodes)})


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("seed", SEEDS)
def test_run_cluster_bit_identical(seed, kind, engine):
    ref, port = (_run(pkg, seed, KINDS[kind], engine)
                 for pkg in ("ref", "port"))
    _same(port, ref)
    assert port[0].event_log == ref[0].event_log
    assert len(port[0].event_log) > 0


@pytest.mark.parametrize("kind", ["failures", "everything"])
@pytest.mark.parametrize("seed", SEEDS)
def test_engines_agree_and_conserve(seed, kind):
    """The port's vector engine is its scalar oracle, report and log, and
    the crash-aware ledger audit holds."""
    plan = _scenario("port", seed, KINDS[kind])[0]
    scalar, vector = (_run("port", seed, KINDS[kind], engine)[0]
                      for engine in ENGINES)
    assert scalar == vector and scalar.event_log == vector.event_log
    assert scalar.n_crashes > 0
    assert tfail.check_conservation(scalar, plan) == []


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ["full", "ring:8", "off"])
def test_event_log_modes_bit_identical(mode, engine):
    ref, port = (_run(pkg, 1, KINDS["everything"], engine, mode)
                 for pkg in ("ref", "port"))
    _same(port, ref)
    assert port[0].event_log_mode == mode
    assert len(port[0].event_log) == {"full": len(port[0].event_log),
                                      "ring:8": 8, "off": 0}[mode]


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_arrays_and_block_arrays_in(seed):
    """``ClusterPlanArrays`` + ``BlockArrays`` in (the streamed path) gives
    the reference's report too."""
    outs = []
    for pkg in ("ref", "port"):
        core, _, _, rt = PKG[pkg]
        plan, truth, _, events, cfg = _scenario(pkg, seed,
                                                KINDS["everything"])
        outs.append(rt.run_cluster(plan.to_arrays(),
                                   core.BlockArrays.from_blocks(truth),
                                   config=cfg, events=events))
    _same(outs[1], outs[0])


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_chaos_scenario_bit_identical(seed):
    ref, port = rfail.chaos_scenario(seed), tfail.chaos_scenario(seed)
    for key in ("seed", "plan", "truth", "blocks", "events", "_cfg_kwargs"):
        _same(getattr(port, key), getattr(ref, key))
    pc, rc_ = port.config(), ref.config()
    _same(dataclasses.replace(pc, calibrator=None),
          dataclasses.replace(rc_, calibrator=None))
    _same(_calibrator_state(pc.calibrator), _calibrator_state(rc_.calibrator))


@pytest.mark.parametrize("base_seed", [0, 40])
def test_run_campaign_bit_identical(base_seed):
    ref = rrt.run_campaign(6, base_seed)
    port = trt.run_campaign(6, base_seed)
    assert port == ref
    assert port["violations"] == []
