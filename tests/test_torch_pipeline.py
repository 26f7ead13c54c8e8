"""Token blocks → block stats → estimates → plan: the port against ``repro``.

Data is bitwise the reference's (NumPy generation).  Stats counts agree
exactly.  Estimates keep ``index`` and ``n_sampled`` exact and ``total`` and
the CI within rtol 1e-6: the reference sums mass in float32 inside its
kernel, the port sums it exactly, and the per-row sums run in another order.
Plans on those estimates pick the same frequency for every block.  Cluster
plans (``plan_estimates(nodes=...)``, with and without a power cap) and
calibrated plans (``PipelineConfig(calibration=...)``: a ``CostFit``, a
``CounterTrace`` or both) on the same estimates are the reference's, bit for
bit, as are calibrated token estimates.
"""
import dataclasses

import numpy as np
import pytest

from repro.data import BlockDataset as RefDataset
from repro.pipeline import PipelineConfig as RefConfig
from repro.pipeline import stream_estimates as ref_stream_estimates
from repro.pipeline import stream_estimates_tokens as ref_tokens
from repro.pipeline import plan_estimates as ref_plan_estimates
from repro.pipeline import stream_plan as ref_plan
from repro.pipeline import stream_run as ref_stream_run
from repro.pipeline import synthetic_cost_chunks
import repro.calibrate as rcal
import repro.cluster as rcl
import repro.core as rcore
import repro.runtime as rrt
import repro_torch.calibrate as tcal
import repro_torch.cluster as tcl
import repro_torch.core as tcore
import repro_torch.runtime as trt
from repro_torch.core import CPU_PAPER_POWER, EstimateArrays
from repro_torch.data import BlockDataset
from repro_torch.pipeline import (PipelineConfig, plan_estimates,
                                  stream_estimates, stream_estimates_tokens,
                                  stream_plan, stream_run,
                                  token_chunk_estimates)
from repro_torch.pipeline import synthetic_cost_chunks as \
    tsynthetic_cost_chunks
from test_torch_cluster import _same

DATASETS = [dict(n_blocks=5, records_per_block=48, max_len=32, seed=9),
            dict(n_blocks=4, records_per_block=64, max_len=24, seed=4,
                 variety_z=2.0),
            dict(n_blocks=3, records_per_block=200, max_len=40, seed=1,
                 vocab=1000)]


@pytest.mark.parametrize("kw", DATASETS)
def test_blocks_bitwise_equal_to_reference(kw):
    port, ref = BlockDataset(**kw), RefDataset(**kw)
    np.testing.assert_array_equal(port.match_densities(),
                                  ref.match_densities())
    for i in range(kw["n_blocks"]):
        a, b = port.block(i), ref.block(i)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        assert port.stats(i).as_dict() == ref.stats(i).as_dict()


@pytest.mark.parametrize("kw", DATASETS)
def test_stats_soa_matches_reference(kw):
    got = BlockDataset(**kw).stats_soa(chunk_size=2, device="cpu")
    want = RefDataset(**kw).stats_soa(chunk_size=2, interpret=True)
    for key in ("records", "tokens", "tokens_padded", "matches", "selected"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)


@pytest.mark.parametrize("kw", DATASETS)
@pytest.mark.parametrize("fraction", [0.05, 0.3])
def test_token_estimates_and_plans_match_reference(kw, fraction):
    port_cfg = PipelineConfig(fraction=fraction, power=CPU_PAPER_POWER)
    ref_cfg = RefConfig(fraction=fraction, power=port_cfg.power)
    got = stream_estimates_tokens(
        BlockDataset(**kw).iter_token_chunks(2, device="cpu"), port_cfg,
        device="cpu")
    want = ref_tokens(RefDataset(**kw).iter_token_chunks(2), ref_cfg,
                      interpret=True)
    np.testing.assert_array_equal(got.index, want.index)
    np.testing.assert_array_equal(got.n_sampled, want.n_sampled)
    np.testing.assert_array_equal(got.n_records, want.n_records)
    for key in ("total", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=1e-6)
    for planner in ("paper", "global"):
        for slack in (1.08, 1.2):
            deadline = float(want.total.sum()) * slack
            pa = stream_plan(got, deadline, PipelineConfig(
                planner=planner, power=CPU_PAPER_POWER))
            pr = ref_plan(want, deadline, RefConfig(
                planner=planner, power=port_cfg.power))
            np.testing.assert_array_equal(pa.rel_freq, pr.rel_freq)
            assert pa.feasible == pr.feasible


def test_token_estimates_chunk_invariant_and_planable():
    """Mirrors tests/test_pipeline.py's token-pipeline test on the port."""
    ds = BlockDataset(n_blocks=10, records_per_block=48, max_len=32, seed=9)
    e1 = stream_estimates_tokens(ds.iter_token_chunks(3, device="cpu"),
                                 device="cpu")
    e2 = stream_estimates_tokens(ds.iter_token_chunks(10, device="cpu"),
                                 device="cpu")
    np.testing.assert_array_equal(e1.total, e2.total)
    np.testing.assert_array_equal(e1.ci_high, e2.ci_high)
    assert np.isfinite(e1.total).all()
    assert np.all(e1.ci_high >= e1.total) and np.all(e1.ci_low <= e1.total)
    pa = stream_plan(e1, float(e1.total.sum()) * 1.3, PipelineConfig())
    assert pa.feasible and len(pa) == 10


def test_token_chunk_estimates_takes_numpy_and_empty_chunks():
    ds = BlockDataset(n_blocks=2, records_per_block=32, max_len=16, seed=2)
    toks = np.stack([ds.block(i)["tokens"] for i in range(2)])
    a = token_chunk_estimates(toks, start_index=0, device="cpu")
    (_, t), = ds.iter_token_chunks(2, device="cpu")
    b = token_chunk_estimates(t, start_index=0, device="cpu")
    np.testing.assert_array_equal(a.total, b.total)
    empty = token_chunk_estimates(np.zeros((0, 32, 16), np.int32),
                                  start_index=0, device="cpu")
    assert isinstance(empty, EstimateArrays) and len(empty) == 0


def test_cost_stream_estimates_bit_identical():
    """The NumPy sampling stage is a copy: same chunks, same bits."""
    cfg = PipelineConfig(chunk_size=7)
    got = stream_estimates(synthetic_cost_chunks(20, 16, seed=2,
                                                 chunk_size=7), cfg)
    want = ref_stream_estimates(synthetic_cost_chunks(20, 16, seed=2,
                                                      chunk_size=7),
                                RefConfig(chunk_size=7))
    for key in ("index", "total", "ci_low", "ci_high", "n_sampled",
                "n_records"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


def test_default_device_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = BlockDataset(n_blocks=2, records_per_block=16, max_len=8, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.iter_token_chunks(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.stats_soa(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        token_chunk_estimates(np.zeros((1, 4, 8), np.int32), start_index=0)


def test_synthetic_cost_chunks_bit_identical():
    got = list(tsynthetic_cost_chunks(23, 16, z=1.5, seed=4, chunk_size=7))
    want = list(synthetic_cost_chunks(23, 16, z=1.5, seed=4, chunk_size=7))
    assert [c.keys() for c in got] == [c.keys() for c in want]
    for a, b in zip(got, want):
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _runtime_kwargs(core, rt, variant, deadline):
    """``stream_run`` keywords of one variant, built from ``rt``'s classes."""
    if variant == "default":
        return {}
    pw = core.TPU_V5E_POWER      # every node's default power model
    cap = 4 * (pw.p_idle + 0.55 * (pw.p_full - pw.p_idle))
    if variant == "cap_only":
        return dict(power_cap_w=cap)
    cfg = rt.RuntimeConfig(
        online=True, migrate=True, recovery=rt.RecoveryPolicy(),
        actuation=rt.ActuationModel(latency_s=0.05, switch_energy_j=1.0),
        migration=rt.MigrationModel(latency_s_per_block=0.1,
                                    energy_j_per_record=1e-4))
    events = (rt.FaultEvent(time=0.3 * deadline, node="b", factor=2.0),
              rt.NodeFailureEvent(time=0.5 * deadline, node="c",
                                  repair_s=0.1 * deadline))
    return dict(runtime=cfg, events=events,
                power_cap_w=cap if variant == "everything_capped" else None)


def _run_both(ests, truths, variant, deadline):
    """``stream_run`` of the reference and of the port, each on its own
    estimates (or chunk source) and truth."""
    outs = []
    pkgs = ((rcore, rcl, rrt, ref_stream_run, RefConfig),
            (tcore, tcl, trt, stream_run, PipelineConfig))
    for (core, cl, rt, run, cfg), est, truth in zip(pkgs, ests, truths):
        nodes = [cl.NodeSpec(n, speed=s) for n, s in
                 zip("abcd", (1.0, 0.7, 1.3, 0.9))]
        outs.append(run(est, deadline, cfg(power=CPU_PAPER_POWER),
                        nodes=nodes, truth=truth,
                        **_runtime_kwargs(core, rt, variant, deadline)))
    return outs


VARIANTS = ["default", "cap_only", "everything", "everything_capped"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_run_on_cost_chunks_matches_reference(variant):
    """Dataset → plan → event-driven run from each package's own chunk
    source: the same ``RuntimeReport`` and event log."""
    kw = dict(n_blocks=40, records_per_block=24, seed=6, chunk_size=9)
    ests = (synthetic_cost_chunks(**kw), tsynthetic_cost_chunks(**kw))
    want_est = ref_stream_estimates(synthetic_cost_chunks(**kw))
    deadline = 1.4 * float(want_est.total.sum()) / 4
    ref, port = _run_both(ests, (None, None), variant, deadline)
    _same(port, ref)
    assert port.event_log == ref.event_log
    assert sum(nr.n_blocks for nr in port.node_reports) >= 40
    assert (port.power_cap_w is None) == (variant in ("default",
                                                        "everything"))
    if variant.startswith("everything"):
        assert port.n_crashes == 1 and len(port.event_log) > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_run_on_port_token_estimates_matches_reference(variant):
    """The port's token estimates (its CPU path of the block-stats kernel),
    handed to both packages as ``EstimateArrays`` of the same arrays; the
    truth runs 10% over the estimates and carries the blocks' record
    counts (migration prices its transfers by them)."""
    kw = DATASETS[0]
    ds = BlockDataset(**dict(kw, n_blocks=12))
    got = stream_estimates_tokens(ds.iter_token_chunks(4, device="cpu"),
                                  PipelineConfig(power=CPU_PAPER_POWER),
                                  device="cpu")
    stats = ds.stats_soa(chunk_size=4, device="cpu")
    true_cost = 1.1 * got.total
    arrays = [getattr(got, f) for f in ("index", "total", "ci_low", "ci_high",
                                        "n_sampled", "n_records")]
    ests = (rcore.EstimateArrays(*arrays), tcore.EstimateArrays(*arrays))
    truths = tuple(core.BlockArrays.build(true_cost, index=got.index,
                                          records=stats["records"].astype(
                                              float))
                   for core in (rcore, tcore))
    deadline = 1.5 * float(true_cost.sum()) / 4
    ref, port = _run_both(ests, truths, variant, deadline)
    _same(port, ref)
    assert port.event_log == ref.event_log


def test_stream_run_power_cap_must_agree_with_runtime():
    """Like the reference: a ``power_cap_w`` that contradicts
    ``runtime.power_cap_w`` raises, an equal one runs, and a runtime
    without a cap takes ``power_cap_w``."""
    nodes = [tcl.NodeSpec(n) for n in "ab"]
    est = np.ones((6, 8))     # a dense cost source, as both packages take
    for run, rt, cl_nodes in (
            (stream_run, trt, nodes),
            (ref_stream_run, rrt, [rcl.NodeSpec(n) for n in "ab"])):
        cfg = rt.RuntimeConfig(power_cap_w=400.0, log_events=False)
        with pytest.raises(ValueError, match="disagrees"):
            run(est, 40.0, nodes=cl_nodes, runtime=cfg, power_cap_w=300.0)
    same = stream_run(est, 40.0, nodes=nodes, power_cap_w=400.0,
                      runtime=trt.RuntimeConfig(power_cap_w=400.0))
    taken = stream_run(est, 40.0, nodes=nodes, power_cap_w=400.0,
                       runtime=trt.RuntimeConfig())
    assert same.power_cap_w == taken.power_cap_w == 400.0
    assert same == taken and same.deadline_met


def _same_plan(a, b):
    """ClusterPlanArrays / PlanArrays equality, bit for bit."""
    if hasattr(b, "node_plans"):
        assert (a.planner, a.deadline_s, a.feasible, a.power_cap_ok) == \
            (b.planner, b.deadline_s, b.feasible, b.power_cap_ok)
        assert len(a.node_plans) == len(b.node_plans)
        for x, y in zip(a.node_plans, b.node_plans):
            assert type(x.node).__name__ == type(y.node).__name__
            assert dataclasses.asdict(x.node) == dataclasses.asdict(y.node)
            _same_plan(x.plan, y.plan)
        return
    for key in ("index", "rel_freq", "pred_time_s", "pred_energy_j"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert (a.planner, a.deadline_s, a.feasible) == \
        (b.planner, b.deadline_s, b.feasible)


def _cluster_inputs(core, cl, cal, seed):
    """Four nodes (speeds 1.0, 0.7, 1.3, 0.9), a trace of three of them and
    a cost fit, from the seed."""
    nodes = [cl.NodeSpec(n, speed=s) for n, s in
             zip("abcd", (1.0, 0.7, 1.3, 0.9))]
    trace = cal.CounterTrace.concat([
        cal.synthetic_trace(n, core.PowerModel(220.0 - 20 * k, 60.0, 2.2),
                            speed=0.8 + 0.2 * k, n_samples=40, noise=0.02,
                            seed=seed + k) for k, n in enumerate("abc")])
    rng = np.random.default_rng(seed)
    rec = rng.integers(16, 64, 80).astype(float)
    f = rng.choice(np.arange(0.5, 1.001, 0.1), 80)
    fit = cal.fit_cost_model(rec, f, rec * 1e-3 * np.maximum(0.7 / f, 1.0))
    return nodes, trace, fit


@pytest.mark.parametrize("calibration", [None, "fit", "trace", "both"])
@pytest.mark.parametrize("cap", [None, 0.9, 0.6])
def test_cluster_plans_match_reference(cap, calibration):
    """``plan_estimates(nodes=...)`` on the same estimates: uncapped, and
    capped at a share of the uncapped plan's nodes' summed full power."""
    est = stream_estimates(synthetic_cost_chunks(24, 32, seed=5,
                                                 chunk_size=10))
    plans = []
    for core, cl, cal, plan, cfg in (
            (rcore, rcl, rcal, ref_plan_estimates, RefConfig),
            (tcore, tcl, tcal, plan_estimates, PipelineConfig)):
        nodes, trace, fit = _cluster_inputs(core, cl, cal, 3)
        cal_arg = {None: None, "fit": fit, "trace": trace,
                   "both": (fit, trace)}[calibration]
        deadline = 1.4 * float(est.total.sum()) / len(nodes)
        cap_w = None if cap is None else \
            cap * sum(nd.power.p_full for nd in nodes)
        plans.append(plan(est, deadline, cfg(calibration=cal_arg),
                          nodes=nodes, power_cap_w=cap_w))
    _same_plan(plans[1], plans[0])
    if calibration in ("trace", "both"):
        assert type(plans[1].node_plans[0].node).__name__ == \
            "CalibratedNodeSpec"


@pytest.mark.parametrize("planner", ["paper", "global"])
def test_calibrated_single_node_plans_and_token_estimates_match_reference(
        planner):
    """A ``CostFit`` prices token blocks by record count alone (no rows
    sampled, no kernel) and stamps the plan's blocks with its roofline."""
    kw = DATASETS[0]
    _, _, tfit = _cluster_inputs(tcore, tcl, tcal, 1)
    _, _, rfit = _cluster_inputs(rcore, rcl, rcal, 1)
    got = stream_estimates_tokens(
        BlockDataset(**kw).iter_token_chunks(2, device="cpu"),
        PipelineConfig(calibration=tfit), device="cpu")
    want = ref_tokens(RefDataset(**kw).iter_token_chunks(2),
                      RefConfig(calibration=rfit), interpret=True)
    for key in ("index", "total", "ci_low", "ci_high", "n_sampled",
                "n_records"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    deadline = 1.2 * float(want.total.sum())
    _same_plan(plan_estimates(got, deadline, PipelineConfig(
                   planner=planner, calibration=tfit)),
               ref_plan_estimates(want, deadline, RefConfig(
                   planner=planner, calibration=rfit)))


def test_power_cap_needs_nodes_and_calibration_is_typed():
    est = stream_estimates(np.ones((3, 8)))
    with pytest.raises(ValueError, match="nodes"):
        plan_estimates(est, 10.0, power_cap_w=100.0)
    with pytest.raises(TypeError, match="CostFit"):
        stream_plan(est, 10.0, PipelineConfig(calibration=object()))
