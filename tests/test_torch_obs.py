"""The port's copied fleet observatory is bit-identical to the reference.

``repro_torch.obs`` is a NumPy copy, not an import, of ``repro.obs``.  Each
package's ``obs`` reads its own package's reports, so the same seeded
scenarios are built in both packages (``_scenario(pkg, seed)``, a copy of
``tests/test_runtime_vector.py:_scenario`` that takes the package) and the
results are compared as plain values, field by field, under both engines:
span forests (per block and per job), streaming metrics and their rows and
table text, the Chrome-trace, Prometheus and JSONL exports, the validators'
verdicts (malformed inputs included), ``explain_miss`` / ``explain_energy``,
the counterfactual rows, run diffs, the watchdog's alert stream and its
replanner hook, and the refusals of truncated logs.

The seed list includes 840380, the reference's own inexact case: there
``explain_miss``'s seven parts of node ``n1`` fsum to one ulp above
``wall_s`` (a reference fault the copy keeps, ROADMAP Queue 3).
"""
import dataclasses
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.cluster as rcl
import repro.cluster.controller as rctl
import repro.core as rc
import repro.obs as robs
import repro.runtime as rrt
import repro.runtime.events as rev
import repro.serving as rsv
import repro_torch.cluster as tcl
import repro_torch.cluster.controller as tctl
import repro_torch.core as tc
import repro_torch.obs as tobs
import repro_torch.runtime as trt
import repro_torch.runtime.events as tev
import repro_torch.serving as tsv
import test_runtime_vector as tvr
from test_torch_cluster import _same

PKG = {
    "ref": SimpleNamespace(core=rc, cl=rcl, rt=rrt, obs=robs, sv=rsv,
                           ctl=rctl, ev=rev),
    "port": SimpleNamespace(core=tc, cl=tcl, rt=trt, obs=tobs, sv=tsv,
                            ctl=tctl, ev=tev),
}
ENGINES = ["scalar", "vector"]
SEEDS = [3, 19, 840380]
# random scenarios, the everything-on scenario and its crash variant
CASES = [f"seed{s}" for s in SEEDS] + ["everything7", "crash7"]
SERVING_SEEDS = [5, 11, 23]
MISS_KEYS = ("queueing_s", "cap_clamp_s", "crash_s", "migration_s",
             "slowdown_s", "actuation_s", "service_s")
CHANNELS = ("busy_j", "idle_j", "switch_j", "wire_j", "failed_j")


def _scenario(pkg, seed):
    """``test_runtime_vector._scenario(seed)`` built from ``pkg``."""
    p = PKG[pkg]
    core, cl, rt = p.core, p.cl, p.rt
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 250))
    blocks = []
    for i in range(n):
        est = float(rng.uniform(0.2, 3.0))
        roof = None
        if rng.random() < 0.4:
            roof = core.RooflineTimeModel(core.RooflineTerms(
                t_comp=est * float(rng.uniform(0.3, 0.8)),
                t_mem=est * float(rng.uniform(0.1, 0.5)),
                t_coll=est * float(rng.uniform(0, 0.2)),
                t_fixed=est * float(rng.uniform(0, 0.2))))
        blocks.append(core.BlockInfo(
            index=i, est_time_fmax=est,
            est_rel_halfwidth=float(rng.uniform(0, 0.25)),
            util=float(rng.uniform(0.4, 1.0)), roofline=roof,
            records=float(rng.integers(50, 4000))))
    k = int(rng.integers(2, 6))
    lows = sorted(rng.choice([0.4, 0.5, 0.6, 0.7, 0.8, 0.9], size=2,
                             replace=False))
    ladder = core.FrequencyLadder(tuple(float(v) for v in lows) + (1.0,))
    nodes = [cl.NodeSpec(f"n{j}", ladder=ladder,
                         power=core.PowerModel(
                             p_idle=30 + 3 * j, p_full=120 + 10 * j,
                             alpha=float(rng.uniform(1.5, 3.0))),
                         speed=float(rng.uniform(0.7, 1.4)))
             for j in range(k)]
    tight = float(rng.uniform(0.6, 1.4))
    deadline = max(sum(b.est_time_fmax for b in blocks) / k * tight, 5.0)
    plan = cl.plan_cluster(blocks, nodes, deadline_s=deadline)
    truth = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax *
                                 float(rng.uniform(0.6, 2.0)))
             for b in blocks]
    events = []
    for _ in range(int(rng.integers(0, 5))):
        events.append(rt.FaultEvent(time=float(rng.uniform(1, deadline)),
                                    node=f"n{int(rng.integers(0, k))}",
                                    factor=float(rng.uniform(1.05, 2.0))))
    for _ in range(int(rng.integers(0, 3))):
        events.append(cl.SlowdownEvent(
            node=f"n{int(rng.integers(0, k))}",
            after_block=int(rng.integers(1, 30)),
            factor=float(rng.uniform(1.1, 1.8))))
    latency = float(rng.choice([0.0, 0.0, 0.3, 1.0]))
    idle_floor = sum(nd.power.p_idle for nd in nodes)
    cap = None
    if rng.random() < 0.6:
        cap = idle_floor + float(rng.uniform(0.3, 1.5)) * \
            sum(nd.power.p_full - nd.power.p_idle for nd in nodes) / k
    online = bool(rng.random() < 0.8)
    migrate = online and bool(rng.random() < 0.6)
    cfg = rt.RuntimeConfig(
        online=online, migrate=migrate,
        actuation=rt.ActuationModel(
            latency_s=latency,
            switch_energy_j=float(rng.choice([0.0, 0.25]))),
        migration=rt.MigrationModel(
            latency_s_per_block=float(rng.choice([0.0, 1.0, 3.0])),
            energy_j_per_record=float(rng.choice([0.0, 0.005, 0.02]))),
        power_cap_w=cap, log_events=True)
    return plan, truth, cfg, events, blocks


def _everything_on(pkg, seed=7):
    """``test_runtime_vector._everything_on_parts(seed)`` from ``pkg``."""
    rt = PKG[pkg].rt
    plan, truth, cfg, events, blocks = _scenario(pkg, seed)
    if not events:
        events = [rt.FaultEvent(time=2.0, node="n0", factor=1.5)]
    cap = cfg.power_cap_w
    if cap is None:
        cap = 1e9
    cfg = dataclasses.replace(
        cfg, online=True, migrate=True, power_cap_w=cap,
        actuation=rt.ActuationModel(latency_s=0.3, switch_energy_j=0.25),
        migration=rt.MigrationModel(latency_s_per_block=1.0,
                                    energy_j_per_record=0.005),
        log_events=True)
    return plan, truth, cfg, events, blocks


def _crash(pkg, seed=7):
    """``tests/test_obs.py:_crash_parts`` from ``pkg``."""
    rt = PKG[pkg].rt
    plan, truth, cfg, events, blocks = _everything_on(pkg, seed)
    events = list(events) + [
        rt.NodeFailureEvent(time=8.0, node="n1", flavor="transient",
                            repair_s=5.0),
        rt.NodeFailureEvent(time=15.0, node="n2", flavor="permanent")]
    cfg = dataclasses.replace(cfg, recovery=rt.RecoveryPolicy())
    return plan, truth, cfg, events, blocks


def _parts(pkg, case):
    if case.startswith("seed"):
        return _scenario(pkg, int(case[4:]))
    return (_everything_on if case.startswith("everything") else _crash)(
        pkg, int(case[-1]))


def _run(pkg, parts, engine, **cfg_kw):
    plan, truth, cfg, events, blocks = parts
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    return PKG[pkg].rt.run_cluster(plan, truth, config=cfg, events=events,
                                   est_blocks=blocks, engine=engine)


def _both(fn):
    """``fn(pkg)`` for the reference and the port: (ref, port)."""
    return fn("ref"), fn("port")


def _serving(pkg, seed, engine, **cfg_kw):
    sv = PKG[pkg].sv
    sc = sv.serving_scenario(seed)
    cfg = dataclasses.replace(sc.config(), **cfg_kw) if cfg_kw \
        else sc.config()
    return sv.run_serving(sc.plan, sc.truth, sc.arrivals, config=cfg,
                          serving=sc.serving, events=sc.events,
                          est_blocks=sc.blocks, engine=engine)


# ------------------------------------------------------------- the inputs --

@pytest.mark.parametrize("seed", SEEDS + [7])
def test_scenario_copy_gives_the_reference_inputs(seed):
    """For ``pkg="ref"`` the copies build the reference tests' own inputs;
    for ``"port"`` the same values, field by field."""
    assert _scenario("ref", seed) == tvr._scenario(seed)
    assert _everything_on("ref", seed) == tvr._everything_on_parts(seed)
    _same(_scenario("port", seed), _scenario("ref", seed))


# ------------------------------------------------------------------ spans --

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("engine", ENGINES)
def test_spans_bit_identical(engine, case):
    ref, port = _both(lambda p: PKG[p].obs.flatten(PKG[p].obs.build_spans(
        _run(p, _parts(p, case), engine).event_log)))
    assert ref
    _same(port, ref)


@pytest.mark.parametrize("seed", SERVING_SEEDS[:2])
@pytest.mark.parametrize("engine", ENGINES)
def test_job_spans_bit_identical(engine, seed):
    def spans(p):
        o = PKG[p].obs
        srep = _serving(p, seed, engine)
        s = o.build_spans(srep.event_log)
        return o.flatten(s), o.flatten(o.build_job_spans(srep, s))

    ref, port = _both(spans)
    assert ref[1]
    _same(port, ref)


# ---------------------------------------------------------------- metrics --

_TABLE = [("node", "node", "s"), ("blocks", "blocks", "d"),
          ("in", "in", "d"), ("out", "out", "d"),
          ("busy_s", "busy", "9.2f"), ("finish_s", "finish_s", ".1f"),
          ("energy_j", "energy_j", ".0f"), ("state", "state", "s")]


def _metrics_view(mx, rep, obs):
    rows = obs.node_rows(rep)
    return (mx.snapshot(), mx.energy_split(), mx.peak_power_w,
            mx.power_timeline(), mx.util_timeline(), mx.depth_timeline(),
            mx.rate_timeline("finish"), rows, obs.format_table(rows, _TABLE))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_metrics_bit_identical(engine, case):
    def view(p):
        o = PKG[p].obs
        mx = o.StreamingMetrics()
        rep = _run(p, _parts(p, case), engine, metrics=mx)
        return _metrics_view(mx, rep, o)

    ref, port = _both(view)
    _same(port, ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_metrics_rebin_and_no_log_bit_identical(engine):
    """A horizon that forces rebins, and a run with the event log off."""
    def view(p, **kw):
        o = PKG[p].obs
        mx = o.StreamingMetrics(**kw)
        rep = _run(p, _everything_on(p), engine, metrics=mx,
                   event_log="off" if not kw else "full")
        return _metrics_view(mx, rep, o)

    for kw in ({"bins": 64, "horizon_s": 1e-3}, {}):
        ref, port = _both(lambda p: view(p, **kw))
        _same(port, ref)


@pytest.mark.parametrize("seed", SERVING_SEEDS[:2])
@pytest.mark.parametrize("engine", ENGINES)
def test_serving_metrics_and_tenant_rows_bit_identical(engine, seed):
    cols = [("tenant", "tenant", "s"), ("arrived", "arrived", "d"),
            ("accepted", "accepted", "d"), ("rejected", "rejected", "d"),
            ("shed", "shed", "d"), ("slo_miss", "slo_miss", "d"),
            ("miss_rate", "miss_rate", ".1%")]

    def view(p):
        o = PKG[p].obs
        mx = o.StreamingMetrics()
        srep = _serving(p, seed, engine, metrics=mx)
        rows = o.tenant_rows(srep)
        return (mx.snapshot(), mx.energy_split(), rows,
                o.format_table(rows, cols, indent="  "),
                [mx.tenant_timeline(t["tenant"]) for t in rows])

    ref, port = _both(view)
    assert ref[2]
    _same(port, ref)


# ---------------------------------------------------------------- exports --

@pytest.mark.parametrize("case", ["seed19", "everything7", "crash7"])
@pytest.mark.parametrize("engine", ENGINES)
def test_exports_bit_identical(engine, case, tmp_path):
    def export(p):
        o = PKG[p].obs
        mx = o.StreamingMetrics()
        rep = _run(p, _parts(p, case), engine, metrics=mx)
        doc = o.write_chrome_trace(tmp_path / f"{p}.json", rep)
        n = o.write_jsonl(tmp_path / f"{p}.jsonl", rep.event_log)
        prom = (o.to_prometheus(mx), o.to_prometheus(rep))
        verdicts = (o.validate_chrome_trace(doc),
                    [o.validate_prometheus(t) for t in prom])
        return (json.dumps(doc, sort_keys=True), prom, n,
                (tmp_path / f"{p}.json").read_bytes(),
                (tmp_path / f"{p}.jsonl").read_bytes(),
                list(o.to_jsonl(rep.event_log)), verdicts)

    ref, port = _both(export)
    assert ref[-1] == ([], [[], []])
    _same(port, ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_serving_chrome_trace_bit_identical(engine, tmp_path):
    def export(p):
        o = PKG[p].obs
        doc = o.write_chrome_trace(tmp_path / f"{p}.json",
                                   _serving(p, 5, engine))
        return (tmp_path / f"{p}.json").read_bytes(), \
            o.validate_chrome_trace(doc)

    ref, port = _both(export)
    assert ref[1] == []
    _same(port, ref)


# tests/test_obs.py:409-420
CHROME_BAD = [[], {"traceEvents": {}}] + [{"traceEvents": [ev]} for ev in (
    {"ph": "Q", "name": "x", "pid": 0, "ts": 0.0},
    {"ph": "X", "name": "x", "pid": 0, "ts": -1.0, "dur": 1.0},
    {"ph": "X", "name": "x", "pid": 0, "ts": 0.0, "dur": "long"},
    {"ph": "C", "name": "x", "pid": 0, "ts": 0.0, "args": {"v": "hi"}},
    {"ph": "X", "name": "", "pid": 0, "ts": 0.0, "dur": 1.0},
    {"ph": "X", "name": "x", "pid": "zero", "ts": 0.0, "dur": 1.0})]
# tests/test_obs_cf.py:296-307
GOOD = ("# HELP repro_x Stuff.\n"
        "# TYPE repro_x counter\n"
        'repro_x{node="n0"} 1.0\n')
PROM_BAD = [GOOD[:-1], "# TYPE repro_x counter\nrepro_x 1\n",
            GOOD + "# TYPE repro_x gauge\n",
            GOOD.replace("counter", "accumulator"), GOOD + "repro_y 1.0\n",
            GOOD.replace(' 1.0', ' -1.0'), GOOD + 'repro_x{node="n0"} 2.0\n',
            GOOD.replace('"n0"', '"n\\q0"'), GOOD.replace(" 1.0", " banana")]


@pytest.mark.parametrize("i", range(len(CHROME_BAD)))
def test_chrome_validator_verdicts_match_on_malformed(i):
    ref, port = _both(lambda p: PKG[p].obs.validate_chrome_trace(
        CHROME_BAD[i]))
    assert ref
    assert port == ref


@pytest.mark.parametrize("i", range(len(PROM_BAD)))
def test_prometheus_validator_verdicts_match_on_malformed(i):
    ref, port = _both(lambda p: PKG[p].obs.validate_prometheus(PROM_BAD[i]))
    assert ref
    assert port == ref


# ------------------------------------------------------------ attribution --

def _explain(p, case, engine):
    o = PKG[p].obs
    rep = _run(p, _parts(p, case), engine)
    spans = o.build_spans(rep.event_log)
    specs = [npa.node for npa in _parts(p, case)[0].to_arrays().node_plans]
    return ([o.explain_miss(rep, node=nr.name, spans=spans)
             for nr in rep.node_reports],
            o.explain_energy(rep),
            [o.explain_energy(rep, node=s.name, specs=specs) for s in specs])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("engine", ENGINES)
def test_explain_bit_identical(engine, case):
    ref, port = _both(lambda p: _explain(p, case, engine))
    _same(port, ref)
    # the energy channels are the report's own totals, exactly
    ee = port[1]
    assert math.fsum([ee[k] for k in CHANNELS]) == ee["total_j"]


def test_explain_miss_copies_the_reference_inexact_case():
    """_scenario(840380), vector engine, node n1: the port gives the
    reference's parts and wall, bit for bit, including the reference's
    one-ulp miss of its own exact-sum claim (ROADMAP Queue 3)."""
    ref, port = _both(lambda p: _explain(p, "seed840380", "vector")[0])
    _same(port, ref)
    n1 = next(ex for ex in port if ex["node"] == "n1")
    assert n1["wall_s"] == 167.95204775588454
    assert math.fsum([n1[k] for k in MISS_KEYS]) == 167.95204775588456


@pytest.mark.parametrize("seed", SERVING_SEEDS)
def test_explain_miss_per_job_bit_identical(seed):
    def per_job(p):
        o = PKG[p].obs
        srep = _serving(p, seed, "vector")
        spans = o.build_spans(srep.event_log)
        return [o.explain_miss(srep, job_id=jr.job_id, spans=spans)
                for jr in srep.jobs]

    ref, port = _both(per_job)
    assert ref
    _same(port, ref)


def test_explain_miss_argument_errors_match():
    for kw, err in (({}, ValueError), ({"job_id": 0, "node": "n0"},
                                       ValueError),
                    ({"node": "nope"}, KeyError), ({"job_id": 0}, TypeError)):
        msgs = []
        for p in ("ref", "port"):
            rep = _run(p, _scenario(p, 3), "vector")
            with pytest.raises(err) as e:
                PKG[p].obs.explain_miss(rep, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# --------------------------------------------------------- counterfactual --

def _cf(p, parts):
    plan, truth, cfg, events, blocks = parts
    return PKG[p].obs.Scenario(plan=plan, truth=truth, config=cfg,
                               events=tuple(events), est_blocks=blocks)


@pytest.mark.parametrize("case", ["seed3", "seed840380", "everything7",
                                  "crash7"])
def test_profile_mechanisms_bit_identical(case):
    engines = ("vector", "scalar") if case == "everything7" else ("vector",)
    ref, port = _both(lambda p: PKG[p].obs.profile_mechanisms(
        _cf(p, _parts(p, case)), engines=engines))
    _same(port, ref)
    assert [r["mechanism"] for r in port] == \
        [m for m in tobs.MECHANISMS if m != "admission"]


def test_ablate_and_delta_ledger_bit_identical():
    def view(p):
        o = PKG[p].obs
        sc = _cf(p, _everything_on(p))
        base = sc.run(engine="vector")
        out = []
        for mech in ("dvfs", "migration", "power_cap", "actuation"):
            abl = o.ablate(sc, mech, engines=("vector",))
            neutral, changed = o.neutralize(sc, mech)
            out.append((mech, changed, abl, o.delta_ledger(base, abl)))
        return base, out

    ref, port = _both(view)
    _same(port, ref)


def _shedding_seed():
    """The first seeded serving scenario whose guarded run sheds
    (``tests/test_obs_cf.py:_shedding_serving_scenario``)."""
    for seed in range(40):
        ss = rsv.serving_scenario(seed)
        if not (ss.serving.admission or ss.serving.shedding):
            continue
        rep = rsv.run_serving(ss.plan, ss.truth, ss.arrivals,
                              config=ss.config(), serving=ss.serving,
                              arrival_truth=ss.arrival_truth,
                              events=ss.events, est_blocks=ss.blocks,
                              engine="vector")
        if rep.n_shed > 0:
            return seed
    raise AssertionError("no shedding serving scenario in the seed sweep")


def _serving_cf(p, seed):
    ss = PKG[p].sv.serving_scenario(seed)
    return PKG[p].obs.Scenario(
        plan=ss.plan, truth=ss.truth, config=ss.config(),
        events=tuple(ss.events), est_blocks=ss.blocks, arrivals=ss.arrivals,
        serving=ss.serving, arrival_truth=ss.arrival_truth)


def test_serving_counterfactual_and_diff_bit_identical():
    seed = _shedding_seed()

    def view(p):
        o = PKG[p].obs
        sc = _serving_cf(p, seed)
        rows = o.profile_mechanisms(sc, mechanisms=["admission"],
                                    engines=("vector",))
        guarded = sc.run(engine="vector")
        opened = o.ablate(sc, "admission", engines=("vector",))
        return rows, o.diff_runs(guarded, opened), o.diff_runs(opened,
                                                               guarded)

    ref, port = _both(view)
    assert ref[0][0]["changed"] and ref[1].added
    _same(port, ref)


# -------------------------------------------------------------------- diff --

@pytest.mark.parametrize("engine", ENGINES)
def test_diff_runs_bit_identical(engine):
    def view(p):
        o = PKG[p].obs
        sc = _cf(p, _everything_on(p))
        a, b = sc.run(engine=engine), sc.run(engine=engine)
        abl = o.ablate(sc, "migration", engines=(engine,))
        return o.diff_runs(a, b), o.diff_runs(a, abl), o.diff_runs(abl, a)

    ref, port = _both(view)
    assert ref[0].empty and not ref[1].empty
    _same(port, ref)


# ---------------------------------------------------------------- watchdog --

class _Hook:
    """An ``OnlineReplanner`` that records what each alert re-planned."""

    def __init__(self, ctl):
        self.ctl, self.calls = ctl, []

    def on_alert(self, alert):
        n = self.ctl.on_alert(alert)
        self.calls.append((alert, n))
        return n


@pytest.mark.parametrize("engine", ENGINES)
def test_watchdog_alerts_and_replanner_hook_bit_identical(engine):
    def watch(p):
        o = PKG[p].obs
        plan, truth, cfg, events, blocks = _everything_on(p)
        fired = []
        hook = _Hook(PKG[p].ctl.OnlineReplanner(plan, est_blocks=blocks))
        mx = o.StreamingMetrics()
        wd = o.Watchdog(o.standard_rules(plan.deadline_s,
                                         energy_budget_j=30_000.0,
                                         shed_budget_hz=0.5),
                        on_fire=fired.append, replanner=hook).attach(mx)
        PKG[p].rt.run_cluster(plan, truth,
                              config=dataclasses.replace(cfg, metrics=mx),
                              events=events, est_blocks=blocks,
                              engine=engine)
        return wd.alerts, fired, hook.calls, wd.poll()

    ref, port = _both(watch)
    assert ref[0] and ref[2]
    _same(port, ref)


def test_online_replanner_on_alert_bit_identical():
    def view(p):
        o = PKG[p].obs
        plan, truth, cfg, events, blocks = _everything_on(p)
        ctl = PKG[p].ctl.OnlineReplanner(plan, est_blocks=blocks)
        risk = o.Alert(time=1.0, rule="deadline-risk",
                       signal="deadline_risk", window_s=1.0,
                       severity="page", value=2.0, slow_value=2.0)
        cap = dataclasses.replace(risk, rule="cap", signal="cap_pressure")
        return ctl.on_alert(risk), ctl.on_alert(cap)

    ref, port = _both(view)
    assert port == ref and ref[1] == 0


def test_watchdog_rule_errors_match():
    for args in (("bad", "vibes", 1.0, 5.0), ("bad", "deadline_risk", 5.0,
                                               1.0)):
        msgs = []
        for p in ("ref", "port"):
            with pytest.raises(ValueError) as e:
                PKG[p].obs.Rule(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------ truncated logs ---

@pytest.mark.parametrize("mode", ["ring:64", "off"])
def test_truncated_logs_refused_with_the_same_messages(mode):
    def view(p):
        o = PKG[p].obs
        rep = _run(p, _everything_on(p), "vector", event_log=mode)
        msgs = []
        for tool in (o.build_spans, lambda r: o.explain_miss(r, node="n0"),
                     o.explain_energy):
            with pytest.raises(ValueError) as e:
                tool(rep)
            msgs.append(str(e.value))
        return rep.event_log_mode, msgs, o.diff_runs(rep, rep)

    ref, port = _both(view)
    assert ref[0] == mode and all(mode in m for m in ref[1])
    assert not ref[2].spans_aligned
    _same(port, ref)


def test_ring_sink_and_stateful_scenario_refused_alike():
    msgs = []
    for p in ("ref", "port"):
        sink = PKG[p].ev.EventLogSink(2)
        sink.extend([(0.0, "block_start", "n0", 0, 1.0),
                     (1.0, "block_finish", "n0", 0, 1.0, 50.0),
                     (2.0, "block_start", "n0", 1, 1.0)])
        with pytest.raises(ValueError) as e1:
            PKG[p].obs.build_spans(sink)
        plan, truth, cfg, events, blocks = _scenario(p, 3)
        bad = dataclasses.replace(cfg, metrics=PKG[p].obs.StreamingMetrics())
        with pytest.raises(ValueError) as e2:
            PKG[p].obs.Scenario(plan=plan, truth=truth, config=bad)
        msgs.append((str(e1.value), str(e2.value)))
    assert "ring" in msgs[0][0] and "metrics" in msgs[0][1]
    assert msgs[0] == msgs[1]


def test_obs_exports_the_reference_names():
    assert tobs.__all__ == robs.__all__
    assert tobs.MECHANISMS == robs.MECHANISMS
