"""The port's serving engine and DVFS controller against the JAX package's.

``ServingEngine.generate`` on ``smoke_config("olmo-1b",
attn_impl_train="pallas")``, on ``smoke_config("mamba2-1.3b")`` (its
prefill through the ``ssd_scan`` wrapper) and on
``smoke_config("qwen2-moe-a2.7b")`` (MoE FFNs with a shared expert), and on
olmo-1b with the int8 KV cache (``kv_quant=True``), with the
reference's weights (carried across by ``params_from_numpy``) and the same
seeded prompts gives the reference's greedy tokens, with the same ledger
step counts; the window walls, and so the plans' frequencies, are measured
and differ run to run.  With ``replicas=3`` (the reference's case,
``tests/test_serve.py:62-91``) the tokens equal a single replica's and the
reference's, the ledgers count the same steps, and the cluster plan of a
given window time is the reference's, frequency for frequency.  The copied
``train/dvfs_controller.py`` is held bit-identical to the reference.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.train.dvfs_controller as jdc
from repro.checkpoint.ckpt import _flatten as ckpt_flatten
from repro.configs import smoke_config as jsmoke
from repro.models import transformer as JT
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
import repro_torch.core as tc
from repro_torch.cluster import NodeSpec
import repro_torch.train.dvfs_controller as tdc
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as TT
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine


def _roofline(mod, mem_bound=True):
    return mod.RooflineTimeModel.from_counts(
        flops=1e9, hbm_bytes=8e9 if mem_bound else 1e6, coll_bytes=0)


def _engines(impl="pallas", window=8, arch="olmo-1b", kv_quant=False,
             **sc_kw):
    jc = jsmoke(arch, attn_impl_train=impl, kv_quant=kv_quant)
    tc_ = tsmoke(arch, attn_impl_train=impl, kv_quant=kv_quant)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    sc_kw.setdefault("slack", 1.15)
    kw = dict(batch=2, max_len=128, window=window, planner="roofline", **sc_kw)
    jeng = JServingEngine(jc, jp, JServeConfig(**kw), roofline=_roofline(rc))
    teng = ServingEngine(tc_, tp, ServeConfig(**kw), roofline=_roofline(tc),
                         device="cpu")
    prompts = np.random.default_rng(0).integers(1, jc.vocab, (2, 16)).astype(
        np.int32)
    return jeng, teng, prompts


@pytest.mark.parametrize("impl,n_tokens,window", [("pallas", 24, 8),
                                                  ("chunked", 24, 8),
                                                  ("pallas", 8, 16),
                                                  ("pallas", 1, 8)])
def test_generate_matches_reference(impl, n_tokens, window):
    _check_generate(*_engines(impl, window=window), n_tokens)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-moe-a2.7b"])
def test_mamba_generate_matches_reference(arch):
    """mamba2-1.3b at smoke size (prefill through the ssd_scan wrapper,
    decode through the recurrence) and qwen2-moe-a2.7b (prefill and decode
    through apply_moe): three DV-DVFS windows."""
    _check_generate(*_engines(window=8, arch=arch), 24)


@pytest.mark.parametrize("n_tokens,window", [(24, 8), (8, 16)])
def test_int8_kv_cache_generate_matches_reference(n_tokens, window):
    """olmo-1b with the int8 KV cache (``kv_quant``, the opt decode
    config): each new K/V row quantized at its per-row absmax / 127 in the
    prefill and in every decode step, and dequantized for attention; the
    greedy tokens and ledger step counts equal the reference's."""
    jeng, teng, prompts = _engines(window=window, kv_quant=True)
    assert jeng.cfg.kv_quant and teng.cfg.kv_quant
    _check_generate(jeng, teng, prompts, n_tokens)


def _check_generate(jeng, teng, prompts, n_tokens):
    jout = jeng.generate({"tokens": jax.numpy.asarray(prompts)}, n_tokens)
    tout = teng.generate({"tokens": prompts}, n_tokens)
    np.testing.assert_array_equal(tout["tokens"].numpy(),
                                  np.asarray(jout["tokens"]))
    assert tout["tokens"].shape == (2, n_tokens + 1)
    assert tout["n_generated"] == jout["n_generated"]
    for key in ("energy", "energy_dvo"):
        assert tout[key]["steps"] == jout[key]["steps"]
    assert len(teng.actuator.history) == len(jeng.actuator.history)
    assert (teng.plan is None) == (jeng.plan is None)
    if teng.plan is not None:
        assert len(teng.plan.blocks) == len(jeng.plan.blocks)
    return tout


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_past_the_cache_end_matches_reference(kv_quant):
    """A prompt that fills the cache (``prefill(..., max_len=S)``), then
    three ``decode_step``s at positions S, S + 1 and S + 2, past the
    cache's end: the reference's ``dynamic_update_slice`` clamps its start
    and overwrites the last slot each step, and so must the port (a write
    at ``[:, S:S + 1]`` would be dropped).  Every step's logits and every
    cache leaf within 1e-5 (float32 sums in another order); the int8
    cache's codes equal, its scales within 1e-5."""
    jc = jsmoke("olmo-1b", kv_quant=kv_quant)
    tc_ = tsmoke("olmo-1b", kv_quant=kv_quant)
    jp = JT.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    s = 16
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, jc.vocab, (2, s)).astype(np.int32)
    jl, jcache = JT.prefill(jp, jc, {"tokens": jax.numpy.asarray(prompts)}, s)
    tl, tcache = TT.prefill(tp, tc_, {"tokens": torch.from_numpy(prompts)}, s)
    last = flatten({"blocks": tcache["blocks"]})
    last = {k: v[:, -1].clone() for k, v in last.items()
            if k.endswith("§k") or k.endswith("§k_q")}
    assert last
    for step in range(3):
        tok = rng.integers(1, jc.vocab, (2, 1)).astype(np.int32)
        jl, jcache = JT.decode_step(jp, jc, jax.numpy.asarray(tok), jcache)
        tl, tcache = TT.decode_step(tp, tc_, torch.from_numpy(tok), tcache)
        assert tcache["pos"] == int(jcache["pos"]) == s + step + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        jleaves = ckpt_flatten({"blocks": jcache["blocks"]})
        tleaves = flatten({"blocks": tcache["blocks"]})
        assert tleaves.keys() == jleaves.keys()
        for key, want in jleaves.items():
            got, want = tleaves[key].numpy(), np.asarray(want)
            assert got.dtype == want.dtype, key
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{key}, step {step}")
    # the last slot holds the newest keys, not the prompt's last
    for key, was in last.items():
        assert not torch.equal(tleaves[key][:, -1], was), key


def test_generate_is_deterministic_and_downclocks_memory_bound_decode():
    _, teng, prompts = _engines(window=8)
    out = teng.generate({"tokens": prompts}, 32)
    _, teng2, _ = _engines(window=8)
    out2 = teng2.generate({"tokens": prompts}, 32)
    assert torch.equal(out["tokens"], out2["tokens"])
    assert out["energy"]["busy_j"] < out["energy_dvo"]["busy_j"]
    assert any(f < 1.0 for f in teng.actuator.history)


def test_short_generation_has_no_windows():
    _, teng, prompts = _engines(window=16)
    out = teng.generate({"tokens": prompts}, 8)
    assert out["energy"]["busy_j"] == out["energy_dvo"]["busy_j"]
    assert teng.plan is None


REPLICAS = dict(replicas=3, replica_speeds=(1.0, 0.8, 1.25), slack=1.4)


def test_multi_replica_generate_matches_reference():
    """3 heterogeneous replicas under a shared SLO (tests/test_serve.py:
    62-91): tokens equal the reference's and a single replica's, every
    window is pinned to its replica, the slow host clocks at least as high
    as the fast one, and the ledgers count the reference's steps."""
    jeng, teng, prompts = _engines(**REPLICAS)
    tout = _check_generate(jeng, teng, prompts, 32)
    _, single, _ = _engines(slack=1.4)
    out1 = single.generate({"tokens": prompts}, 32)
    assert torch.equal(tout["tokens"], out1["tokens"])
    cp, jcp = teng.cluster_plan, jeng.cluster_plan
    assert cp is not None and cp.feasible == jcp.feasible
    n_windows = len(cp.node_plans[0].blocks)
    for r, (np_, jnp_) in enumerate(zip(cp.node_plans, jcp.node_plans)):
        assert np_.node.name == jnp_.node.name == f"replica{r}"
        assert np_.node.speed == jnp_.node.speed
        assert [bp.index for bp in np_.blocks] == \
            [bp.index for bp in jnp_.blocks] == \
            list(range(r * n_windows, (r + 1) * n_windows))
    mean_freq = [np.mean([bp.rel_freq for bp in p.blocks])
                 for p in cp.node_plans]
    assert mean_freq[1] >= mean_freq[2]
    assert tout["energy"]["busy_j"] <= tout["energy_dvo"]["busy_j"] * 1.01
    assert tout["energy"]["steps"] > out1["energy"]["steps"]


@pytest.mark.parametrize("window_s,deadline", [(0.5, 5.0), (0.02, 0.3),
                                               (1.0, 6.5)])
@pytest.mark.parametrize("mem_bound", [True, False])
def test_replica_plan_bit_identical_to_reference(window_s, deadline,
                                                 mem_bound):
    """``_plan_replicas`` on a given window time and deadline: the same
    cluster plan as the reference's, bit for bit."""
    jeng, teng, _ = _engines(**REPLICAS)
    jeng.actuator = jdc.SimulatedActuator(_roofline(rc, mem_bound))
    teng.actuator = tdc.SimulatedActuator(_roofline(tc, mem_bound))
    jplan = jeng._plan_replicas(4, window_s, deadline)
    tplan = teng._plan_replicas(4, window_s, deadline)
    _same(tplan.blocks, jplan.blocks)
    assert (tplan.planner, tplan.deadline_s, tplan.feasible) == \
        (jplan.planner, jplan.deadline_s, jplan.feasible)
    for np_, jnp_ in zip(teng.cluster_plan.node_plans,
                         jeng.cluster_plan.node_plans):
        _same(np_.blocks, jnp_.blocks)
    assert teng._replica_speeds() == jeng._replica_speeds() == \
        (1.0, 0.8, 1.25)


def test_replica_nodes_normalized_to_replica_zero():
    """``replica_nodes`` take precedence over ``replica_speeds``, speeds
    normalized to replica 0; a count that disagrees raises."""
    nodes = (NodeSpec("r0", speed=2.0), NodeSpec("r1", speed=1.0),
             NodeSpec("r2", speed=3.0))
    _, teng, _ = _engines(replicas=3, replica_speeds=(1.0, 1.0, 1.0),
                          replica_nodes=nodes)
    assert teng._replica_speeds() == (1.0, 0.5, 1.5)
    _, bad, _ = _engines(replicas=2, replica_nodes=nodes[:1])
    with pytest.raises(ValueError, match="replica_nodes"):
        bad._replica_speeds()


def test_engine_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsmoke("olmo-1b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, ServeConfig())


def test_launch_serve_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "yi-6b", "--device", "cpu", "--tokens",
                       "12"])
    out = capsys.readouterr().out
    assert "arch=yi-6b" in out and "generated=13" in out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_launch_serve_runs_mamba_on_cpu(arch, capsys):
    """Mamba, MoE and hybrid archs at smoke size through the CLI."""
    launch_serve.main(["--arch", arch, "--device", "cpu", "--tokens", "12"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "generated=13" in out


# -------------------------------------------- dvfs_controller, bit for bit ---

def _same(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_and_actuator_bit_identical(seed):
    rng = np.random.default_rng(seed)
    secs = rng.uniform(1e-3, 2.0, 40)
    freqs = rng.choice(rc.DEFAULT_LADDER.states, 40)
    utils = rng.uniform(0.2, 1.0, 40)
    for roof in (None, True):
        ja = jdc.SimulatedActuator(_roofline(rc) if roof else None)
        ta = tdc.SimulatedActuator(_roofline(tc) if roof else None)
        jl, tl = jdc.EnergyLedger(chips=4), tdc.EnergyLedger(chips=4)
        for s, f, u in zip(secs, freqs, utils):
            ja.set(f)
            ta.set(f)
            assert ta.effective_time(s) == ja.effective_time(s)
            jl.record(ja.effective_time(s), f, u)
            tl.record(ta.effective_time(s), f, u)
        assert ta.history == ja.history
        _same(tl.summary(), jl.summary())


@pytest.mark.parametrize("planner", ["paper", "global"])
def test_dvfs_controller_bit_identical(planner):
    rng = np.random.default_rng(5)
    names = ("records", "tokens")
    feats = [{"records": float(r), "tokens": float(t)}
             for r, t in rng.uniform(1e3, 1e5, (24, 2))]
    secs = [0.5e-4 * f["records"] + 1e-6 * f["tokens"] for f in feats]
    costs = [rng.gamma(2.0, 1e-4, 400) for _ in feats]
    plans = []
    for mod, core in ((jdc, rc), (tdc, tc)):
        cm = core.CostModel(names).fit(feats, secs)
        ctl = mod.DVFSController(cost_model=cm, planner=planner, seed=3)
        blocks = ctl.estimate_blocks(feats, costs)
        deadline = 1.2 * sum(b.est_time_fmax for b in blocks)
        plans.append((blocks, ctl.make_plan(blocks, deadline),
                      ctl.make_dvo_plan(blocks, deadline),
                      [ctl.freq_for_block(i) for i in range(len(feats))]))
    (jb, jp, jdvo, jf), (tb, tp, tdvo, tf) = plans
    _same(tb, jb)
    _same(tp.blocks, jp.blocks)
    _same(tdvo.blocks, jdvo.blocks)
    assert tf == jf
