"""The port's copied serving fabric and arrivals are bit-identical to ``repro``.

``repro_torch.serving`` and ``repro_torch.pipeline.arrivals`` are NumPy
copies of the reference modules; the same specs must expand to the same
``JobArrival`` schedule, and the same plans and traffic must give the same
``ServingReport`` (jobs, tenants, provisioning flips, the runtime report
and its event log) through both engines.  The port's own scalar and vector
engines agree, and its conservation audit holds.
"""
import dataclasses

import numpy as np
import pytest

import repro.cluster as rcl
import repro.core as rc
import repro.pipeline as rpipe
import repro.runtime as rrt
import repro.serving as rsv
import repro_torch.cluster as tcl
import repro_torch.core as tc
import repro_torch.pipeline as tpipe
import repro_torch.runtime as trt
import repro_torch.serving as tsv
from test_torch_cluster import _same

SEEDS = [0, 1, 2, 5]
ENGINES = ["scalar", "vector"]
PKG = {"ref": (rc, rcl, rpipe, rrt, rsv), "port": (tc, tcl, tpipe, trt, tsv)}


def _tenants(pipe, kind, horizon):
    """Tenants of one arrival process, or a mix of all three."""
    poisson = pipe.TenantSpec("steady", rate_hz=0.8, slo_s=9.0, priority=1.0,
                              blocks_per_job=(1, 3), block_time_s=(0.4, 1.6),
                              records_per_block=120.0)
    burst = pipe.TenantSpec("bursty", rate_hz=0.4, slo_s=12.0, priority=2.0,
                            process="burst", burst_factor=6.0,
                            burst_start_s=0.3 * horizon,
                            burst_end_s=0.5 * horizon)
    trace = pipe.TenantSpec("tight", rate_hz=0.0, slo_s=2.5, priority=3.0,
                            process="trace", block_time_s=(0.3, 0.9),
                            trace_times_s=tuple(np.linspace(
                                0.0, 1.2 * horizon, 9)))
    return {"poisson": (poisson,), "burst": (burst,), "trace": (trace,),
            "mix": (poisson, burst, trace)}[kind]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["poisson", "burst", "trace", "mix"])
def test_generate_arrivals_bit_identical(kind, seed):
    ref, port = (pipe.generate_arrivals(pipe.ArrivalSpec(
        tenants=_tenants(pipe, kind, 40.0), horizon_s=40.0, seed=seed))
        for pipe in (rpipe, tpipe))
    _same(port, ref)
    assert len(port) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_scenario_bit_identical(seed):
    ref, port = rsv.serving_scenario(seed), tsv.serving_scenario(seed)
    for f in dataclasses.fields(ref):
        _same(getattr(port, f.name), getattr(ref, f.name))
    _same(port.config(), ref.config())


def _serve(pkg, seed, engine):
    sv = PKG[pkg][4]
    sc = sv.serving_scenario(seed)
    return sv.run_serving(sc.plan, sc.truth, sc.arrivals, config=sc.config(),
                          serving=sc.serving, arrival_truth=sc.arrival_truth,
                          events=sc.events, est_blocks=sc.blocks,
                          engine=engine), sc.plan


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", SEEDS)
def test_run_serving_bit_identical(seed, engine):
    (ref, _), (port, _) = (_serve(pkg, seed, engine)
                           for pkg in ("ref", "port"))
    _same(port, ref)
    assert port.event_log == ref.event_log and len(port.jobs) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_run_serving_engines_agree_and_conserve(seed):
    (scalar, plan), (vector, _) = (_serve("port", seed, engine)
                                   for engine in ENGINES)
    assert scalar == vector and scalar.event_log == vector.event_log
    assert tsv.check_serving_conservation(scalar, plan) == []


def _three_tenants(pkg, engine):
    """A fixed cluster under the three-process mix, with admission,
    shedding, provisioning, a fault and a cap."""
    core, cl, pipe, rt, sv = PKG[pkg]
    rng = np.random.default_rng(11)
    blocks = [core.BlockInfo(i, float(t), util=float(u), records=300.0)
              for i, (t, u) in enumerate(zip(rng.uniform(0.3, 1.5, 24),
                                             rng.uniform(0.5, 1.0, 24)))]
    ladder = core.FrequencyLadder((0.5, 0.7, 0.85, 1.0))
    nodes = [cl.NodeSpec(f"n{j}", ladder=ladder, speed=1.0 + 0.1 * j,
                         power=core.PowerModel(p_idle=30.0, p_full=110.0,
                                               alpha=2.0))
             for j in range(3)]
    deadline = sum(b.est_time_fmax for b in blocks) / 3 * 1.6
    plan = cl.plan_cluster(blocks, nodes, deadline_s=deadline)
    truth = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax * 1.1)
             for b in blocks]
    arrivals = pipe.ArrivalSpec(tenants=_tenants(pipe, "mix", deadline),
                                horizon_s=deadline, seed=3)
    serving = sv.ServingConfig(provisioning=sv.ProvisioningPolicy(
        wake_latency_s=0.3, wake_energy_j=5.0, park_below=0.2,
        wake_above=0.8))
    cfg = rt.RuntimeConfig(online=True, power_cap_w=250.0,
                           actuation=rt.ActuationModel(latency_s=0.15,
                                                       switch_energy_j=0.1))
    events = [rt.FaultEvent(time=0.3 * deadline, node="n1", factor=1.5)]
    rep = sv.run_serving(plan, truth, arrivals, config=cfg, serving=serving,
                         arrival_truth=1.2, events=events, est_blocks=blocks,
                         engine=engine)
    return rep, plan


@pytest.mark.parametrize("engine", ENGINES)
def test_three_tenant_fabric_bit_identical(engine):
    (ref, _), (port, plan) = (_three_tenants(pkg, engine)
                              for pkg in ("ref", "port"))
    _same(port, ref)
    assert {t.tenant for t in port.tenants} == {"steady", "bursty", "tight"}
    assert port.n_accepted > 0 and port.n_rejected + port.n_shed > 0
    assert tsv.check_serving_conservation(port, plan) == []


@pytest.mark.parametrize("base_seed", [0, 20])
def test_run_serving_campaign_bit_identical(base_seed):
    ref = rsv.run_serving_campaign(4, base_seed)
    port = tsv.run_serving_campaign(4, base_seed)
    assert port == ref
    assert port["violations"] == [] and port["n_jobs"] > 0
