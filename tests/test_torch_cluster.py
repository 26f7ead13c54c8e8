"""The port's copied cluster planner is bit-identical to ``repro.cluster``.

``repro_torch.cluster``, ``repro_torch.train.straggler`` and
``repro_torch.core._reference`` are NumPy copies, not imports, of the
reference modules; the same seeded inputs must give the same bits:
assignments, cluster plans (object and SoA paths, with a power cap, with a
calibration trace, the loop-based reference planner), the independent
baseline, and the online re-planner driven through
``simulate_cluster_reference`` under a mid-run ``SlowdownEvent``, and
``simulate_cluster`` (the copied runtime under the old signature) with
migration, actuation and a power cap.
"""
import dataclasses

import numpy as np
import pytest

import repro.calibrate as rcal
import repro.cluster as rcl
import repro.cluster.planner as rplanner
import repro.core as rc
import repro.core._reference as rref
import repro.runtime as rrt
import repro.train.straggler as rstr
import repro_torch.calibrate as tcal
import repro_torch.cluster as tcl
import repro_torch.cluster.planner as tplanner
import repro_torch.core as tc
import repro_torch.core._reference as tref
import repro_torch.runtime as trt
import repro_torch.train.straggler as tstr

SEEDS = [0, 1, 2]
PKG = {"ref": (rc, rcl, rcal), "port": (tc, tcl, tcal)}


def _same(a, b):
    """Dataclass / array / container / scalar equality, bit for bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def _ladder(core, deep):
    if not deep:
        return core.DEFAULT_LADDER
    return core.FrequencyLadder(
        states=tuple(round(f, 2) for f in np.arange(0.35, 1.001, 0.05)))


def _inputs(pkg, seed, n=30, roofline=True):
    """Seeded blocks (every third with a roofline) and four heterogeneous
    nodes (speeds, ladders and power models differ) of ``pkg``."""
    core, cl, _ = PKG[pkg]
    rng = np.random.default_rng(seed)
    est = rng.gamma(2.0, 2.5, n)
    util = rng.uniform(0.4, 1.0, n)
    blocks = [core.BlockInfo(
        i, float(e), util=float(u),
        roofline=core.RooflineTimeModel.from_counts(
            flops=1e12 * (1 + i % 4), hbm_bytes=6e10 * (1 + i % 3),
            coll_bytes=0) if roofline and i % 3 == 0 else None)
        for i, (e, u) in enumerate(zip(est, util))]
    speeds = rng.uniform(0.6, 1.4, 4)
    nodes = [cl.NodeSpec(f"n{k}", speed=float(s), ladder=_ladder(core, k % 2),
                         power=core.PowerModel(p_full=200.0 + 40 * k,
                                               p_idle=60.0 + 5 * k,
                                               alpha=2.0 + 0.3 * k))
             for k, s in enumerate(speeds)]
    rr = cl.assign_blocks(blocks, nodes, strategy="round_robin")
    deadline = 1.3 * max(sum(b.est_time_fmax for b in g) / nd.speed
                         for g, nd in zip(rr, nodes))
    return blocks, nodes, deadline


def _both(seed, fn, **kw):
    return [fn(pkg, *_inputs(pkg, seed, **kw)) for pkg in ("ref", "port")]


@pytest.mark.parametrize("strategy", ["lpt", "pack", "round_robin",
                                      "explicit"])
@pytest.mark.parametrize("seed", SEEDS)
def test_assign_blocks_bit_identical(seed, strategy):
    def run(pkg, blocks, nodes, deadline):
        cl = PKG[pkg][1]
        s = [i % 3 for i in range(len(blocks))] if strategy == "explicit" \
            else strategy
        groups = cl.assign_blocks(blocks, nodes, strategy=s,
                                  deadline_s=deadline)
        ba = PKG[pkg][0].BlockArrays.from_blocks(blocks)
        pos = cl.assign_block_arrays(ba, nodes, strategy=s,
                                     deadline_s=deadline)
        return [[b.index for b in g] for g in groups], pos
    (rg, rpos), (tg, tpos) = _both(seed, run)
    assert tg == rg
    _same(tpos, rpos)


@pytest.mark.parametrize("assignment", ["auto", "lpt", "pack",
                                        "round_robin"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_cluster_bit_identical(seed, assignment):
    def run(pkg, blocks, nodes, deadline):
        cl = PKG[pkg][1]
        return cl.plan_cluster(blocks, nodes, deadline, assignment=assignment)
    ref, port = _both(seed, run)
    _same(port, ref)
    assert port.pred_total_energy == ref.pred_total_energy


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_cluster_reference_loops_bit_identical(seed):
    """The loop-based oracle (``core._reference.run_downclock_heap_loops``
    behind ``plan_cluster_reference``) gives the reference's plan."""
    def run(pkg, blocks, nodes, deadline):
        planner = rplanner if pkg == "ref" else tplanner
        return planner.plan_cluster_reference(blocks, nodes, deadline)
    ref, port = _both(seed, run, roofline=False)
    _same(port, ref)


@pytest.mark.parametrize("cap_share", [None, 0.95, 0.8, 0.3])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_cluster_arrays_power_cap_bit_identical(seed, cap_share):
    """The SoA path with the Σ-power screen: a cap a share of the nodes'
    summed full power (0.3 is out of reach)."""
    def run(pkg, blocks, nodes, deadline):
        core, cl, _ = PKG[pkg]
        cap = None if cap_share is None else \
            cap_share * sum(nd.power.p_full for nd in nodes)
        return cl.plan_cluster_arrays(core.BlockArrays.from_blocks(blocks),
                                      nodes, deadline, power_cap_w=cap)
    ref, port = _both(seed, run)
    _same(port, ref)
    assert port.power_cap_ok == ref.power_cap_ok
    if cap_share == 0.3:
        assert not port.power_cap_ok
    _same(port.to_cluster_plan(), ref.to_cluster_plan())


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_cluster_with_calibration_trace_bit_identical(seed):
    """``calibration=CounterTrace``: the nodes are upgraded through the
    copied ``calibrate_nodes`` before planning."""
    def run(pkg, blocks, nodes, deadline):
        core, cl, cal = PKG[pkg]
        trace = cal.CounterTrace.concat([
            cal.synthetic_trace(nd.name, core.PowerModel(
                p_full=250.0 - 10 * k, p_idle=50.0 + 3 * k, alpha=2.5),
                speed=nd.speed * (0.8 + 0.1 * k), n_samples=48,
                noise=0.02, seed=seed * 10 + k)
            for k, nd in enumerate(nodes[:3])])
        return cl.plan_cluster(blocks, nodes, deadline, calibration=trace)
    ref, port = _both(seed, run)
    _same(port, ref)
    assert type(port.node_plans[0].node).__name__ == "CalibratedNodeSpec"


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_independent_bit_identical(seed):
    def run(pkg, blocks, nodes, deadline):
        return PKG[pkg][1].plan_independent(blocks, nodes, deadline)
    ref, port = _both(seed, run, roofline=False)
    _same(port, ref)


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_online_replanner_through_simulate_reference(seed, online):
    """The plan executed against a drifted truth, with a 2x slowdown on one
    node from its fourth block on; online, the ``OnlineReplanner`` re-plans
    the tails.  Reports, replan logs and straggler events are the
    reference's."""
    def run(pkg, blocks, nodes, deadline):
        core, cl, _ = PKG[pkg]
        rng = np.random.default_rng(100 + seed)
        truth = [dataclasses.replace(
            b, est_time_fmax=b.est_time_fmax * float(rng.uniform(0.8, 1.3)))
            for b in blocks]
        plan = cl.plan_cluster(blocks, nodes, deadline * 1.3)
        events = (cl.SlowdownEvent("n1", 3, 2.0),
                  cl.SlowdownEvent("n2", 5, 1.5))
        report = cl.simulate_cluster_reference(
            plan, truth, est_blocks=blocks, online=online, events=events)
        ctl = cl.OnlineReplanner(plan, blocks)
        for nd in nodes:
            for t in rng.uniform(1.0, 6.0, 6):
                if ctl.next_block(nd.name) is None:
                    break
                ctl.observe(nd.name, float(t))
        return (report, ctl.replan_log,
                [ctl.straggler_events(nd.name) for nd in nodes],
                [ctl.drift_of(nd.name) for nd in nodes])
    ref, port = _both(seed, run, roofline=False)
    _same(port, ref)
    if online:
        assert port[0].n_replans > 0


SIM_OPTIONS = {
    "plain": {},
    "online": dict(online=True),
    "migrate": dict(migrate=True),
    "actuation": dict(actuation=(0.4, 1.5)),
    "cap": dict(power_cap=0.35),
    "everything": dict(online=True, migrate=True, actuation=(0.4, 1.5),
                       power_cap=0.35),
}


@pytest.mark.parametrize("options", list(SIM_OPTIONS))
@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_cluster_bit_identical(seed, options):
    """``simulate_cluster`` (the runtime under the old signature), with
    drifted truths, separate estimates, a block-count slowdown and a
    time-based fault: the reference's ``ClusterReport``, bit for bit."""
    def run(pkg, blocks, nodes, deadline):
        cl = PKG[pkg][1]
        rt = trt if pkg == "port" else rrt
        plan = cl.plan_cluster(blocks, nodes, deadline)
        rng = np.random.default_rng(seed + 10)
        truth = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax
                                     * float(rng.uniform(0.8, 1.6)))
                 for b in blocks]
        kw = dict(SIM_OPTIONS[options])
        if "actuation" in kw:
            lat, joules = kw.pop("actuation")
            kw["actuation"] = rt.ActuationModel(lat, joules)
        if "power_cap" in kw:
            share = kw.pop("power_cap")
            kw["power_cap_w"] = sum(
                nd.power.p_idle + share * (nd.power.p_full - nd.power.p_idle)
                for nd in nodes)
        events = [cl.SlowdownEvent(nodes[0].name, after_block=2, factor=1.6),
                  rt.FaultEvent(time=0.4 * deadline, node=nodes[1].name,
                                factor=1.4)]
        return cl.simulate_cluster(plan, truth, est_blocks=blocks,
                                   events=events, **kw)
    ref, port = _both(seed, run)
    _same(port, ref)
    assert port.n_replans > 0 or options in ("plain", "actuation", "cap")


@pytest.mark.parametrize("seed", SEEDS)
def test_straggler_detector_bit_identical(seed):
    rng = np.random.default_rng(seed)
    secs = rng.gamma(4.0, 0.5, 60) * np.where(rng.random(60) < 0.1, 4.0, 1.0)
    slots = rng.uniform(1.0, 3.0, 60)
    r = rstr.StragglerDetector(alpha=0.3, warmup_steps=3)
    t = tstr.StragglerDetector(alpha=0.3, warmup_steps=3)
    flags = [(r.observe(i, float(s), float(p) if i % 2 else None),
              t.observe(i, float(s), float(p) if i % 2 else None))
             for i, (s, p) in enumerate(zip(secs, slots))]
    assert [a for a, _ in flags] == [b for _, b in flags]
    _same(t, r)


@pytest.mark.parametrize("planner", ["paper", "global"])
@pytest.mark.parametrize("seed", SEEDS)
def test_core_reference_oracles_bit_identical(seed, planner):
    """``core._reference``: the loop-based planner and sampler."""
    outs = []
    for core, ref in ((rc, rref), (tc, tref)):
        rng = np.random.default_rng(seed)
        blocks = [core.BlockInfo(i, float(e), est_rel_halfwidth=float(h))
                  for i, (e, h) in enumerate(zip(rng.gamma(2.0, 1.0, 24),
                                                 rng.uniform(0, 0.2, 24)))]
        deadline = 1.2 * sum(b.est_time_fmax for b in blocks)
        costs = [rng.gamma(2.0, 1e-3, int(n))
                 for n in rng.integers(40, 400, 6)]
        outs.append((ref.plan_dvfs_reference(blocks, deadline,
                                             planner=planner),
                     ref.sample_blocks_reference(costs, fraction=0.1,
                                                 seed=seed)))
    _same(outs[1], outs[0])
