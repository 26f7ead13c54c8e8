"""The port's examples and ``launch/optconfig.py`` against the reference's.

``repro_torch.examples.{cluster_sim,calibrate}`` and part 1 of
``quickstart`` are NumPy and print the reference examples' text exactly (the
reference's ``examples/*.py`` run in this process through ``runpy``).
Quickstart part 2, ``train_lm --preset tiny`` and ``serve_batch`` put
tensors on a device; here they run on the CPU with the reference's weights
carried across (``params_from_numpy``) and both packages' wall clocks
replaced by one that advances 10 ms a reading, so the measured walls, and
with them the plans and the ledgers, are the same on both sides:

* training: every step's loss within rtol 1e-5 (the ``Trainer`` tolerance
  of ``tests/test_torch_train.py``), the same steps, frequencies and ledger
  step counts, the saving against DVO within 1e-6;
* serving (``spec=V5E`` on both sides): the reference's greedy tokens,
  ledger step counts, window frequencies and saving, and its printed text.

``examples.paper_figs.run_app_comparison`` returns the reference's dict
exactly for every app, planner and slack, and ``bigdata_apps`` prints the
reference's text, when both packages time a block by one deterministic
function of it (on smaller blocks of the same kinds).

Asked for a card that is not there, each of the four raises before any
work.  The launcher's roofline is the H100's unless a ``spec`` is given.
"""
import dataclasses
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.optconfig as joc
import repro.launch.serve as jlaunch
import repro.models.transformer as JT
import repro.serve.engine as jserve
import repro.train.loop as jloop
import repro_torch.launch.optconfig as toc
import repro_torch.serve.engine as tserve
import repro_torch.train.loop as tloop
from repro_torch.core import V5E
from repro_torch.device import F32_FLOPS, H100, HBM_BYTES_PER_S
from repro_torch.examples import (bigdata_apps, calibrate, cluster_sim,
                                  paper_figs, quickstart, serve_batch,
                                  train_lm)
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _reference(name, monkeypatch, capsys, *argv):
    """Run ``examples/<name>.py`` as a script; its printed text."""
    capsys.readouterr()
    path = str(EXAMPLES / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


class _Clock:
    """Stands in for a module's ``time``: ``perf_counter`` advances 10 ms a
    reading, so every measured wall is 10 ms in both packages."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


def _record(monkeypatch, owner, name, sink):
    """Wrap ``owner.name`` so each call's ``(args, result)`` lands in
    ``sink``."""
    orig = getattr(owner, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        sink.append((args, out))
        return out

    monkeypatch.setattr(owner, name, spy)


def _carry_weights(monkeypatch, jinit):
    """The port's trainer starts from the reference's first initial
    weights (``jinit[0]``)."""
    def init_state(self):
        params = params_from_numpy(jax.tree.map(np.asarray, jinit[0][1]),
                                   self.device)
        return params, adamw_init(params, self.opt_cfg)

    monkeypatch.setattr(tloop.Trainer, "_init_state", init_state)


def _saving(res):
    return 1 - res["energy"]["busy_j"] / max(res["energy_dvo"]["busy_j"],
                                             1e-9)


def _same_training(got, want):
    assert [h["step"] for h in got["history"]] == \
        [h["step"] for h in want["history"]]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=1e-5)
    assert [h["rel_freq"] for h in got["history"]] == \
        [h["rel_freq"] for h in want["history"]]
    for key in ("energy", "energy_dvo"):
        assert got[key]["steps"] == want[key]["steps"]
    assert abs(_saving(got) - _saving(want)) <= 1e-6
    assert _saving(got) > 0.0


def _trace(monkeypatch):
    """Fixed clocks in both trainers; spies on the reference's weights and
    both packages' ``Trainer.run``."""
    jinit, jruns, truns = [], [], []
    monkeypatch.setattr(jloop, "time", _Clock())
    monkeypatch.setattr(tloop, "time", _Clock())
    _record(monkeypatch, JT, "init_params", jinit)
    _record(monkeypatch, jloop.Trainer, "run", jruns)
    _record(monkeypatch, tloop.Trainer, "run", truns)
    _carry_weights(monkeypatch, jinit)
    return jruns, truns


# ------------------------------------------------------- NumPy examples ---

@pytest.mark.parametrize("name,module", [("cluster_sim", cluster_sim),
                                         ("calibrate", calibrate)])
def test_numpy_example_prints_the_reference_text(name, module, monkeypatch,
                                                 capsys):
    want = _reference(name, monkeypatch, capsys)
    module.main()
    got = capsys.readouterr().out
    assert want and got == want


def test_cluster_sim_returns_what_it_prints(capsys):
    out = cluster_sim.main()
    assert out["online_demo"]["online"].deadline_met
    assert out["migration_demo"]["migration"].deadline_met
    assert out["crash_recovery_demo"]["recovery"].deadline_met
    assert out["overload_serving_demo"]["guarded"].accepted_miss_rate == 0.0
    assert out["counterfactual_demo"]["alerts"]
    assert calibrate.main()["calibrated"].deadline_met


# ------------------------------------------------------------- quickstart ---

def test_quickstart_matches_the_reference(monkeypatch, capsys):
    jruns, truns = _trace(monkeypatch)
    want = _reference("quickstart", monkeypatch, capsys)
    out = quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out
    part1 = want.split("=== 2)")[0]
    assert part1.startswith("=== 1)") and got.split("=== 2)")[0] == part1
    assert all(r.deadline_met for r in out["scheduler"].values())
    (_, jres), (_, tres) = jruns[0], truns[0]
    assert out["training"] is tres
    _same_training(tres, jres)


def test_train_lm_tiny_matches_the_reference(monkeypatch, capsys, tmp_path):
    jruns, truns = _trace(monkeypatch)
    args = ["--preset", "tiny", "--steps", "6"]
    _reference("train_lm", monkeypatch, capsys, *args, "--ckpt-dir",
               str(tmp_path / "j"))
    res = train_lm.main(args + ["--ckpt-dir", str(tmp_path / "t"),
                                "--device", "cpu"])
    assert "device=cpu" in capsys.readouterr().out
    assert len(jruns) == len(truns) == 1 and res is truns[0][1]
    _same_training(res, jruns[0][1])
    assert [h["step"] for h in res["history"]] == list(range(6))


def test_train_lm_presets_match_the_reference():
    for preset in ("tiny", "100m"):
        (tcfg, tsz), (jcfg, jsz) = train_lm.make_cfg(preset), \
            runpy.run_path(str(EXAMPLES / "train_lm.py"))["make_cfg"](preset)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tsz == jsz
    cfg, sizes = train_lm.make_cfg("100m")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (12, 768, 32768)
    assert sizes == dict(batch=8, seq_len=512)
    # the reference calls it ~110 M: that is the blocks alone
    assert cfg.param_count() == 163_577_856


# ---------------------------------------------------------------- serving ---

def _serving_trace(monkeypatch):
    """Fixed clocks in both serving engines; the port initialises with the
    reference's first weights; both engines' ``generate`` recorded."""
    jinit, jgen, tgen = [], [], []
    monkeypatch.setattr(jserve, "time", _Clock())
    monkeypatch.setattr(tserve, "time", _Clock())
    _record(monkeypatch, JT, "init_params", jinit)
    _record(monkeypatch, jserve.ServingEngine, "generate", jgen)
    _record(monkeypatch, tserve.ServingEngine, "generate", tgen)
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen, device: (
        params_from_numpy(jax.tree.map(np.asarray, jinit[0][1]), device)))
    return jgen, tgen


def _same_serving(tgen, jgen):
    (targs, tout), (jargs, jout) = tgen[0], jgen[0]
    teng, jeng = targs[0], jargs[0]
    np.testing.assert_array_equal(tout["tokens"].numpy(),
                                  np.asarray(jout["tokens"]))
    assert tout["n_generated"] == jout["n_generated"]
    for key in ("energy", "energy_dvo"):
        assert tout[key]["steps"] == jout[key]["steps"]
    assert [b.rel_freq for b in teng.plan.blocks] == \
        [b.rel_freq for b in jeng.plan.blocks]
    assert teng.actuator.history == jeng.actuator.history
    assert abs(_saving(tout) - _saving(jout)) <= 1e-6
    return teng


def test_serve_batch_matches_the_reference_on_its_roofline(monkeypatch,
                                                           capsys):
    jgen, tgen = _serving_trace(monkeypatch)
    want = _reference("serve_batch", monkeypatch, capsys, "--tokens", "24")
    serve_batch.serve(tokens=24, device="cpu", spec=V5E)
    assert capsys.readouterr().out == want
    teng = _same_serving(tgen, jgen)
    assert any(f < 1.0 for f in teng.actuator.history)


def test_launch_serve_on_the_cpu_with_v5e_gives_the_reference_plan(
        monkeypatch, capsys):
    jgen, tgen = _serving_trace(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "olmo-1b",
                                      "--tokens", "24"])
    jlaunch.main()
    tlaunch.serve("olmo-1b", tokens=24, device="cpu", spec=V5E)
    _same_serving(tgen, jgen)


def test_the_card_roofline_is_the_h100s(capsys):
    """Without a ``spec``, the launcher and serve_batch plan on the H100's
    data-sheet roofline, not the TPU v5e's."""
    assert (H100.peak_flops, H100.hbm_bw) == (F32_FLOPS, HBM_BYTES_PER_S) \
        == (67e12, 3.35e12)
    for run, batch in ((lambda: tlaunch.serve("olmo-1b", tokens=2,
                                              device="cpu"), 2),
                       (lambda: serve_batch.serve(tokens=2, device="cpu"),
                        4)):
        _, eng = run()
        p = eng.cfg.param_count()
        terms = eng.actuator.roofline.terms
        assert terms.t_comp == 2 * p * batch / H100.peak_flops
        assert terms.t_mem == 2 * p / H100.hbm_bw


# ---------------------------------------------------------- bigdata_apps ---

def _fake_block_seconds(app, block, **kw):
    """A deterministic "measurement" of one block, the same in both
    packages: 10 us plus 1 us a non-zero entry (tokens that are not
    padding, selected rows, ...), so blocks differ as their data do."""
    nonzero = sum(int(np.count_nonzero(np.asarray(v)))
                  for v in block.values())
    return 1e-5 + 1e-6 * nonzero


@pytest.fixture
def small_app_blocks(monkeypatch):
    """Both packages' paper_figs with the deterministic clock above and the
    same smaller blocks: the reference's sizes (up to 2**21 records a
    block, 12 blocks an app) take minutes to generate on the host.  The
    measurement caches start empty."""
    import benchmarks.paper_figs as jfigs
    sizes = {"wordcount": 1024, "grep": 2048, "inverted_index": 256,
             "avg": 8192, "sum": 8192}
    for mod in (jfigs, paper_figs):
        monkeypatch.setattr(mod, "measure_block_seconds",
                            _fake_block_seconds)
        monkeypatch.setattr(mod, "_MEASURE_CACHE", {})
        for app, n in sizes.items():
            monkeypatch.setitem(mod._APP_BLOCKS, app, dict(
                mod._APP_BLOCKS[app], records_per_block=n))
    return jfigs


def test_paper_figs_copies_the_reference_tables():
    import benchmarks.paper_figs as jfigs
    for name in ("SLACK", "_FEATURES", "_APP_BLOCKS", "_APP_KEYS"):
        assert getattr(paper_figs, name) == getattr(jfigs, name), name


@pytest.mark.parametrize("app", bigdata_apps.APPS)
def test_run_app_comparison_equals_the_reference(app, small_app_blocks):
    """Every planner and slack (tight and firm): the reference's dict,
    exactly, on the same blocks, draws and calibration."""
    for planner in ("paper", "global"):
        for slack in paper_figs.SLACK.values():
            want = small_app_blocks.run_app_comparison(
                app, planner=planner, slack=slack)
            got = paper_figs.run_app_comparison(
                app, planner=planner, slack=slack, device="cpu")
            assert got == want


def test_measure_app_is_what_run_app_comparison_plans_from(small_app_blocks,
                                                           monkeypatch):
    """``measure_app`` with ``run_app_comparison``'s arguments gives the
    times the comparison plans from (its DVO run takes their sum), measured
    once; ``clear_measurements`` makes the next call measure anew."""
    calls = []
    monkeypatch.setattr(paper_figs, "measure_block_seconds",
                        lambda *a, **kw: calls.append(1)
                        or _fake_block_seconds(*a, **kw))
    times, t_sub = paper_figs.measure_app("grep", device="cpu")
    assert times.shape == t_sub.shape == (12,) and len(calls) == 24
    r = paper_figs.run_app_comparison("grep", device="cpu")
    assert r["dvo_time_s"] == pytest.approx(times.sum()) and len(calls) == 24
    paper_figs.clear_measurements()
    again, _ = paper_figs.measure_app("grep", device="cpu")
    assert len(calls) == 48 and np.array_equal(again, times)


def test_bigdata_apps_prints_the_reference_text(small_app_blocks,
                                                monkeypatch, capsys):
    for argv in ([], ["--planner", "global", "--slack", "1.08"]):
        want = _reference("bigdata_apps", monkeypatch, capsys, *argv)
        rows = bigdata_apps.main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out == want
        assert list(rows) == list(bigdata_apps.APPS)


# ------------------------------------------------------- device refusals ---

@pytest.mark.parametrize("run", [
    lambda tmp: quickstart.main([]),
    lambda tmp: train_lm.main(["--steps", "2", "--ckpt-dir", str(tmp)]),
    lambda tmp: serve_batch.main([]),
    lambda tmp: serve_batch.serve(device="cuda"),
    lambda tmp: bigdata_apps.main([])],
    ids=["quickstart", "train_lm", "serve_batch", "serve_batch.serve",
         "bigdata_apps"])
def test_example_refuses_a_missing_card(run, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(tmp_path / "ck")
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "ck").exists()


# ------------------------------------------------------------- optconfig ---

@pytest.mark.parametrize("arch", sorted(toc.TRAIN_MICROBATCHES))
def test_optconfig_builds_the_reference_configs(arch):
    for mesh in ({"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4},
                 {"data": 1}):
        for opt in (False, True):
            for kind in ("train", "serve"):
                got = toc.build_cfg(arch, mesh, opt=opt, kind=kind)
                want = joc.build_cfg(arch, mesh, opt=opt, kind=kind)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert toc.microbatches_for(arch, kind, opt) == \
                    joc.microbatches_for(arch, kind, opt)
    assert (toc.OPT_OVERRIDES, toc.OPT_MICROBATCHES) == \
        (joc.OPT_OVERRIDES, joc.OPT_MICROBATCHES)
