"""The port on the card: each CUDA kernel against its plain version, and the
main paths' card runs against their CPU runs.

Marked ``cuda`` and skipped where torch sees no CUDA device.  This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Block statistics: kernel and plain version agree exactly (counts, and mass
as the exact int64 sum cast to float32).  Flash attention: within the
reference's kernel tolerances (float32 2e-5, bfloat16 2e-2).  SSD scan: y
and the final state within the reference's kernel tolerances (float32 5e-4,
bfloat16 5e-2, absolute plus relative).  The serving paths' logits within
1e-4 of the CPU's (float32, summed in another order).  The MoE FFN on the
card within 1e-5 of the CPU's, drops included, with no host synchronise.
``stream_run`` on the card's estimates: both engines give one report, and
the fleet observatory's streaming metrics and attribution read it.
Training: the SSD backward kernels within 1e-4 of each plain gradient's
largest magnitude (autograd of the plain chunked version on the card),
bit-identical from call to call; the flash kernel refuses a call that needs
its backward; olmo train steps on the card within 1e-5 of the CPU's;
smoke mamba2 and jamba gradients within 5e-5 of each leaf's largest, and
their weights after two AdamW steps within 1e-4 (a tenth of an lr-sized
step, argued at the test).  The sharded path at world
size 1 under NCCL (one rank a card): the int8 all-reduce within one
quantization step, and a sharded smoke olmo-1b prefill launching the flash
kernel once a layer on its local heads, its logits and next decode step
equal to the plain path's on the card within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.apps import ALL_APPS
from repro_torch.configs import smoke_config
from repro_torch.data import BlockDataset
from repro_torch.kernels import block_stats as bs
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.launch.mesh import make_mesh, mesh_shape_dict
from repro_torch.obs import StreamingMetrics, explain_energy, explain_miss
from repro_torch.parallel import (batch_specs, distribute_tree,
                                  hierarchical_grad_reduce, int8_all_reduce,
                                  param_specs)
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.cluster import NodeSpec
from repro_torch.pipeline import (PipelineConfig, plan_estimates,
                                  stream_estimates_tokens, stream_plan,
                                  stream_run)
from repro_torch.runtime import (ActuationModel, FaultEvent,
                                 NodeFailureEvent, RecoveryPolicy,
                                 RuntimeConfig, check_conservation,
                                 run_cluster)
from torch_parallel_workers import one_rank_group

pytestmark = pytest.mark.cuda
PAT = (17, 23, 5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases():
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 50, (12, 300, 40)).astype(np.int32)
    lens = rng.integers(1, 301, 12)
    for b in range(12):
        toks[b, lens[b]:, :3] = PAT
    return {
        "ragged-poisoned": (toks, lens, PAT),
        "full": (rng.integers(0, 50, (6, 64, 32)).astype(np.int32), None, PAT),
        "mass-past-2**24": (rng.integers(0, 32768, (4, 2048, 256))
                            .astype(np.int32), None, PAT),
        "clamped-lengths": (rng.integers(0, 50, (5, 40, 16)).astype(np.int32),
                            np.array([0, 41, -3, 40, 7]), PAT),
        "40-token-pattern": (rng.integers(0, 4, (3, 50, 64)).astype(np.int32),
                             None, tuple(range(1, 41))),
        "L<p": (np.full((3, 8, 2), 17, np.int32), None, PAT),
        "odd-L-int32-lengths": (_planted(rng, (3, 37, 13), 3),
                                np.array([37, 20, 1], np.int32), PAT),
        "100000-token-row": (_long_row(rng), None, PAT),
        "5000-blocks": (_planted(rng, (5000, 4, 8), 2),
                        rng.integers(-2, 6, 5000).astype(np.int32), PAT),
        "int64-lengths-2**40": (_planted(rng, (4, 20, 16), 1),
                                np.array([2 ** 40, -2 ** 40, 3, 2 ** 40]),
                                PAT),
        "300-token-pattern": (_long_pattern(rng), None, LONG_PAT),
    }


# longer than the 256 tokens the kernel keeps in shared memory
LONG_PAT = tuple(range(1, 301))


def _long_pattern(rng):
    toks = rng.integers(0, 4, (2, 4, 700)).astype(np.int32)
    toks[:, ::2, 100:400] = LONG_PAT
    toks[1, 2, 399] = 0                  # one window wrong in its last token
    return toks


def _planted(rng, shape, every):
    """Random tokens with the pattern planted in every ``every``-th row."""
    toks = rng.integers(0, 50, shape).astype(np.int32)
    toks[:, ::every, 1:4] = PAT
    return toks


def _long_row(rng):
    """One 100,000-token row with the pattern across token 4096, the first
    16 KiB stage boundary of the kernel's ring, and at the row's end."""
    toks = rng.integers(0, 50, (1, 1, 100000)).astype(np.int32)
    toks[0, 0, 4094:4097] = PAT
    toks[0, 0, 99997:] = PAT
    return toks


@pytest.mark.parametrize("case", list(_cases()))
def test_cuda_kernel_matches_plain_version(cuda, case):
    toks, lens, pattern = _cases()[case]
    dev = torch.from_numpy(toks).to(cuda)
    bs.reset_launches()
    got = bs.block_stats_batched_cuda(dev, lens, pattern)
    want = ref.block_stats_batched_ref(torch.from_numpy(toks), lens, pattern)
    one = bs.block_stats_cuda(dev[0], pattern)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(
        one.cpu().numpy(),
        ref.block_stats_ref(torch.from_numpy(toks[0]), pattern).numpy())
    assert bs.LAUNCHES == {"block_stats": 1, "block_stats_batched": 1}


def test_cuda_kernel_views_at_odd_offsets(cuda):
    """``toks[b, :n]`` views of odd-L blocks start off 16-byte boundaries."""
    rng = np.random.default_rng(10)
    toks = _planted(rng, (4, 9, 13), 2)
    dev = torch.from_numpy(toks).to(cuda)
    for b in range(4):
        view = dev[b, :7 - b]
        assert view.data_ptr() % 16 == (4 * b * 9 * 13) % 16
        np.testing.assert_array_equal(
            bs.block_stats_cuda(view, PAT).cpu().numpy(),
            ref.block_stats_ref(torch.from_numpy(toks[b, :7 - b]), PAT).numpy())


def test_cuda_kernel_writes_zeros_for_an_empty_block(cuda):
    """A block of 0 valid rows between full blocks reads back as zeros when
    its output lands on memory that held non-zero statistics."""
    rng = np.random.default_rng(11)
    dev = torch.from_numpy(_planted(rng, (3, 64, 32), 1)).to(cuda)
    lens = torch.tensor([64, 0, 64], dtype=torch.int32, device=cuda)
    first = bs.block_stats_batched_cuda(dev, None, PAT)
    torch.cuda.synchronize()
    assert bool((first != 0).all())
    ptr = first.data_ptr()
    del first
    got = bs.block_stats_batched_cuda(dev, lens, PAT)
    assert got.data_ptr() == ptr      # the allocator gave the memory back
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.block_stats_batched_ref(
                                      dev.cpu(), lens.cpu(), PAT).numpy())
    assert float(got[1].abs().sum()) == 0.0


def test_cuda_kernel_one_block_over_a_cluster_of_16(cuda):
    rng = np.random.default_rng(12)
    toks = _planted(rng, (1, 2048, 256), 5)
    facts = bs.occupancy(torch.cuda.current_device())
    assert facts["max_cluster"] == 16
    assert bs.launch_shape(1, 2048, 256, facts["slots"], 16) == (16, 1)
    dev = torch.from_numpy(toks).to(cuda)
    want = ref.block_stats_ref(torch.from_numpy(toks[0]), PAT).numpy()
    np.testing.assert_array_equal(bs.block_stats_cuda(dev[0], PAT).cpu()
                                  .numpy(), want)
    np.testing.assert_array_equal(bs.block_stats_batched_cuda(dev, None, PAT)
                                  .cpu().numpy()[0], want)


def _device_events(fn, calls: int = 4) -> list:
    """Names of the device events (kernels, copies, memsets) that ``calls``
    calls of ``fn`` record in one torch.profiler session, for two sessions
    that recorded any (a session has missed the first kernel launched in
    it, and now and then all of them; up to six sessions)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sessions = []
    for _ in range(6):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            sessions.append(names)
        if len(sessions) == 2:
            break
    assert len(sessions) == 2, "the profiler recorded no device events"
    return sessions


@pytest.mark.parametrize("entry", ["batched-int32-lengths", "batched-None",
                                   "single"])
def test_cuda_kernel_is_one_device_kernel_a_call(cuda, entry):
    """No memset, no cast kernel, no aten:: kernel: one launch a call."""
    rng = np.random.default_rng(13)
    dev = torch.from_numpy(_planted(rng, (8, 103, 256), 4)).to(cuda)
    lens = torch.full((8,), 90, dtype=torch.int32, device=cuda)
    fn = {"batched-int32-lengths": lambda: bs.block_stats_batched_cuda(
              dev, lens, PAT),
          "batched-None": lambda: bs.block_stats_batched_cuda(dev, None, PAT),
          "single": lambda: bs.block_stats_cuda(dev[0], PAT)}[entry]
    fn()
    for names in _device_events(fn):
        assert names and all("block_stats_kernel" in n for n in names), names
        assert 3 <= len(names) <= 4, names


def test_cuda_main_path_matches_cpu(cuda):
    ds = BlockDataset(n_blocks=5, records_per_block=256, max_len=64, seed=2)
    cfg = PipelineConfig(fraction=0.1)
    bs.reset_launches()
    card = stream_estimates_tokens(ds.iter_token_chunks(2, device=cuda), cfg,
                                   device=cuda)
    assert bs.LAUNCHES["block_stats_batched"] == 3
    cpu = stream_estimates_tokens(ds.iter_token_chunks(2, device="cpu"), cfg,
                                  device="cpu")
    np.testing.assert_array_equal(card.n_sampled, cpu.n_sampled)
    for key in ("total", "ci_low", "ci_high"):
        np.testing.assert_allclose(getattr(card, key), getattr(cpu, key),
                                   rtol=1e-6)
    deadline = float(cpu.total.sum()) * 1.2
    np.testing.assert_array_equal(stream_plan(card, deadline, cfg).rel_freq,
                                  stream_plan(cpu, deadline, cfg).rel_freq)
    soa_card, soa_cpu = ds.stats_soa(2, device=cuda), ds.stats_soa(2,
                                                                   device="cpu")
    for key in soa_cpu:
        np.testing.assert_array_equal(soa_card[key], soa_cpu[key])


def test_cuda_stream_run_engines_agree(cuda):
    """Estimates from the kernel on the card, planned over four nodes and
    executed by ``stream_run`` with a fault, a transient crash, migration,
    actuation and a cap: the vector engine is the scalar oracle, report and
    event log, and the ledger audit holds."""
    ds = BlockDataset(n_blocks=24, records_per_block=256, max_len=64, seed=3)
    bs.reset_launches()
    est = stream_estimates_tokens(ds.iter_token_chunks(8, device=cuda),
                                  PipelineConfig(fraction=0.1), device=cuda)
    assert bs.LAUNCHES["block_stats_batched"] == 3
    nodes = [NodeSpec(n, speed=s) for n, s in zip("abcd", (1.0, 0.7, 1.3,
                                                            0.9))]
    deadline = 1.4 * float(est.total.sum()) / len(nodes)
    truth = est.to_block_arrays()
    truth = dataclasses.replace(truth, est_time_fmax=1.1 * truth.est_time_fmax)
    cfg = RuntimeConfig(online=True, migrate=True,
                        recovery=RecoveryPolicy(),
                        actuation=ActuationModel(latency_s=0.01 * deadline,
                                                 switch_energy_j=1.0))
    events = (FaultEvent(time=0.3 * deadline, node="b", factor=1.6),
              NodeFailureEvent(time=0.5 * deadline, node="c",
                               repair_s=0.1 * deadline))
    pw = nodes[0].power
    cap = len(nodes) * (pw.p_idle + 0.6 * (pw.p_full - pw.p_idle))
    got = stream_run(est, deadline, nodes=nodes, truth=truth, runtime=cfg,
                     events=events, power_cap_w=cap)
    plan = plan_estimates(est, deadline, nodes=nodes, power_cap_w=cap)
    want = run_cluster(plan, truth, engine="scalar", events=events,
                       config=dataclasses.replace(cfg, power_cap_w=cap))
    assert got == want and got.event_log == want.event_log
    assert got.n_crashes == 1 and got.peak_power_w <= cap + 1e-9
    assert check_conservation(want, plan) == []


def test_cuda_stream_run_metrics_and_explain_miss(cuda):
    """A small stream run whose estimates come from the block-statistics
    kernel on the card, with a fault, a transient crash and a cap, fed to
    ``StreamingMetrics`` inline and attributed by ``explain_miss``: the
    metrics agree with the sealed report, each node's parts add up to its
    finish time, and the energy channels to the report's total."""
    ds = BlockDataset(n_blocks=24, records_per_block=256, max_len=64, seed=4)
    bs.reset_launches()
    est = stream_estimates_tokens(ds.iter_token_chunks(8, device=cuda),
                                  PipelineConfig(fraction=0.1), device=cuda)
    assert bs.LAUNCHES["block_stats_batched"] == 3
    nodes = [NodeSpec(n, speed=s) for n, s in zip("abcd", (1.0, 0.7, 1.3,
                                                            0.9))]
    deadline = 1.2 * float(est.total.sum()) / len(nodes)
    truth = est.to_block_arrays()
    truth = dataclasses.replace(truth, est_time_fmax=1.1 * truth.est_time_fmax)
    pw = nodes[0].power
    cap = len(nodes) * (pw.p_idle + 0.6 * (pw.p_full - pw.p_idle))
    mx = StreamingMetrics()
    rep = stream_run(est, deadline, nodes=nodes, truth=truth,
                     runtime=RuntimeConfig(online=True, migrate=True,
                                           recovery=RecoveryPolicy(),
                                           metrics=mx),
                     events=(FaultEvent(time=0.3 * deadline, node="b",
                                        factor=1.6),
                             NodeFailureEvent(time=0.5 * deadline, node="c",
                                              repair_s=0.1 * deadline)),
                     power_cap_w=cap)
    snap = mx.snapshot()
    assert snap["counters"]["finishes"] == \
        sum(nr.n_blocks for nr in rep.node_reports) == 24
    assert snap["counters"]["crashes"] == rep.n_crashes == 1
    assert np.isclose(mx.peak_power_w, rep.peak_power_w)
    keys = ("queueing_s", "cap_clamp_s", "crash_s", "migration_s",
            "slowdown_s", "actuation_s", "service_s")
    for nr in rep.node_reports:
        ex = explain_miss(rep, node=nr.name)
        assert ex["wall_s"] == nr.finish_s
        assert all(ex[k] >= 0.0 for k in keys if k != "service_s")
        assert np.isclose(sum(ex[k] for k in keys), ex["wall_s"],
                          rtol=1e-12, atol=0.0)
    ee = explain_energy(rep)
    assert ee["busy_j"] == rep.total_energy_j
    assert np.isclose(sum(ee[k] for k in ("busy_j", "idle_j", "switch_j",
                                          "wire_j", "failed_j")),
                      ee["total_j"], rtol=1e-12)


@pytest.mark.parametrize("name", list(ALL_APPS))
def test_cuda_apps_match_cpu(cuda, name):
    block = BlockDataset(n_blocks=1, records_per_block=512, max_len=64,
                         seed=1).block(0)
    app = ALL_APPS[name]()
    card, cpu = app.run(block, device=cuda), app.run(block, device="cpu")
    if not isinstance(card, dict):
        card, cpu = {"out": card}, {"out": cpu}
    for key in cpu:
        if name in ("avg", "sum"):
            np.testing.assert_allclose(card[key].cpu().numpy(),
                                       cpu[key].numpy(), rtol=1e-5)
        else:
            np.testing.assert_array_equal(card[key].cpu().numpy(),
                                          cpu[key].numpy())


def test_cuda_bigdata_apps_compares_grep_on_the_card(cuda, monkeypatch):
    """``examples.paper_figs.run_app_comparison`` for grep with every block
    timed on the card (CUDA events), on 12 blocks of 2048 records (the
    reference's 32768 take long to generate): positive block times, finite
    savings and times at both slacks, the estimates calibrated on three
    blocks, and the same measurements for every slack and planner (the
    reference's cache)."""
    from repro_torch.examples import paper_figs
    monkeypatch.setattr(paper_figs, "_MEASURE_CACHE", {})
    monkeypatch.setitem(paper_figs._APP_BLOCKS, "grep", dict(
        paper_figs._APP_BLOCKS["grep"], records_per_block=2048))
    rows = [paper_figs.run_app_comparison("grep", planner=planner,
                                          slack=slack, device=cuda)
            for planner in ("paper", "global")
            for slack in paper_figs.SLACK.values()]
    (times, t_sub), = paper_figs._MEASURE_CACHE.values()
    assert times.shape == t_sub.shape == (12,)
    assert (times > 0).all() and (t_sub > 0).all()
    for r in rows:
        for key in ("energy_improvement", "time_increase", "est_mape",
                    "dvfs_energy_j", "dvo_energy_j", "deadline_s"):
            assert np.isfinite(r[key]), (key, r)
        assert r["deadline_s"] == pytest.approx(times.sum() * r["slack"])
        assert r["dvo_time_s"] == pytest.approx(times.sum())


def test_cuda_bigdata_apps_example_prints_its_table(cuda, monkeypatch,
                                                   capsys):
    """``python -m repro_torch.examples.bigdata_apps`` on the card (blocks
    cut as above for every app): one row an app, every number finite."""
    from repro_torch.examples import bigdata_apps, paper_figs
    monkeypatch.setattr(paper_figs, "_MEASURE_CACHE", {})
    for app in bigdata_apps.APPS:
        monkeypatch.setitem(paper_figs._APP_BLOCKS, app, dict(
            paper_figs._APP_BLOCKS[app], records_per_block=2048))
    rows = bigdata_apps.main(["--device", "cuda"])
    text = capsys.readouterr().out
    assert list(rows) == list(bigdata_apps.APPS)
    assert all(f"\n{app} " in "\n" + text for app in bigdata_apps.APPS)
    assert "nan" not in text.lower() and "inf " not in text.lower()


# (dtype, B, Hq, Hkv, S, D, causal, window, layout): layout "view" is the
# model's (B, H, S, D) view of a (B, S, H, D) tensor, "contig" a contiguous
# tensor, "padded" a view of (B, S, H, D + 2) rows, whose S stride is no
# multiple of 16 bytes, so the wrapper copies it first
FLASH_CASES = {
    "mha-f32": (torch.float32, 2, 4, 4, 256, 128, True, None, "view"),
    "gqa-f32": (torch.float32, 1, 8, 2, 192, 64, True, None, "contig"),
    "mqa-bf16": (torch.bfloat16, 1, 8, 1, 256, 64, True, None, "view"),
    "swa-f32": (torch.float32, 1, 2, 2, 512, 32, True, 100, "contig"),
    "noncausal-bf16": (torch.bfloat16, 2, 2, 1, 130, 128, False, None,
                       "view"),
    "odd-f32": (torch.float32, 1, 2, 2, 80, 16, True, None, "contig"),
    "d16-s80-bf16": (torch.bfloat16, 1, 2, 2, 80, 16, True, None, "view"),
    "d32-s130-bf16": (torch.bfloat16, 2, 4, 2, 130, 32, True, None, "contig"),
    "d32-s130-f32": (torch.float32, 2, 4, 2, 130, 32, True, None, "view"),
    "d64-s1000-f32": (torch.float32, 1, 4, 4, 1000, 64, True, None, "view"),
    "d128-s1000-bf16": (torch.bfloat16, 1, 4, 4, 1000, 128, True, None,
                        "contig"),
    "d16-s1000-f32": (torch.float32, 1, 2, 1, 1000, 16, True, None, "view"),
    "mqa-f32": (torch.float32, 1, 8, 1, 256, 128, True, None, "view"),
    "gqa-bf16": (torch.bfloat16, 2, 8, 2, 192, 32, True, None, "view"),
    "swa48-f32": (torch.float32, 1, 4, 2, 1000, 128, True, 48, "view"),
    "swa48-bf16": (torch.bfloat16, 1, 4, 2, 1000, 128, True, 48, "view"),
    "swa48-d16-bf16": (torch.bfloat16, 1, 2, 1, 300, 16, True, 48, "contig"),
    "noncausal-f32": (torch.float32, 1, 4, 4, 1000, 32, False, None, "view"),
    "noncausal-d64-bf16": (torch.bfloat16, 1, 2, 2, 80, 64, False, None,
                           "contig"),
    "padded-bf16": (torch.bfloat16, 1, 2, 1, 200, 16, True, None, "padded"),
    "padded-f32": (torch.float32, 1, 2, 1, 200, 16, True, None, "padded"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_cuda_flash_attention_matches_plain_version(cuda, case):
    dtype, b, hq, hkv, s, d, causal, window, layout = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))

    def make(h):
        pad = 2 if layout == "padded" else 0
        x = torch.from_numpy(rng.normal(0, 1, (b, s, h, d + pad)).astype(
            np.float32)).to(cuda, dtype)[..., :d].transpose(1, 2)
        return x.contiguous() if layout == "contig" else x

    q, k, v = make(hq), make(hkv), make(hkv)
    assert fa.tma_ready(q) == (layout != "padded")
    fa.reset_launches()
    got = fa.flash_attention_cuda(q, k, v, causal=causal, swa_window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, swa_window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_repeats_on_one_and_two_streams(cuda, dtype):
    """Launches queued back to back on one stream, and launches on two
    streams that may overlap, each give the first launch's output (the
    bfloat16 kernel's work counters are per stream and reset by each
    launch)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 300, h, 64)).astype(
        np.float32)).to(cuda, dtype).transpose(1, 2) for h in (8, 2, 2))
    first = fa.flash_attention_cuda(q, k, v)
    outs = [fa.flash_attention_cuda(q, k, v) for _ in range(8)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    for i in range(8):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(fa.flash_attention_cuda(q, k, v))
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


def test_cuda_flash_attention_refuses_bad_input(cuda):
    q = torch.zeros((1, 2, 64, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, q, q)
    h = torch.zeros((1, 2, 64, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(h, h, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_refuses_a_negative_window(cuda, dtype):
    q = torch.zeros((1, 2, 64, 64), device=cuda, dtype=dtype)
    fa.reset_launches()
    with pytest.raises(ValueError, match="negative"):
        fa.flash_attention_cuda(q, q, q, swa_window=-1)
    with pytest.raises(ValueError, match="negative"):
        ops.flash_attention(q, q, q, swa_window=-1, device=cuda)
    assert fa.LAUNCHES["flash_attention"] == 0


def test_cuda_serving_smoke_matches_cpu(cuda):
    """olmo-1b at smoke size through the flash kernel: the card's greedy
    tokens equal the CPU's, with the same weights and prompts."""
    cfg = smoke_config("olmo-1b", attn_impl_train="pallas")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = {"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 48)).astype(np.int32)}
    sc = ServeConfig(batch=2, max_len=96, window=8, slack=1.2)
    outs = {}
    for dev in ("cpu", cuda):
        fa.reset_launches()
        eng = ServingEngine(cfg, params, sc, device=dev)
        outs[str(dev)] = eng.generate(prompts, n_tokens=20)
        logits, _ = T.prefill(eng.params, cfg,
                              {"tokens": torch.as_tensor(prompts["tokens"],
                                                         device=dev)}, 96)
        outs[str(dev)]["logits"] = logits.cpu()
        if dev == cuda:
            assert fa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    cpu, card = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(card["logits"], cpu["logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(card["tokens"].cpu().numpy(),
                                  cpu["tokens"].numpy())
    assert card["energy"]["steps"] == cpu["energy"]["steps"]


# (dtype, B, S, H, G, P, N): model-layout views, as _run_ssd hands them in
SSD_CASES = {
    "mamba2-heads-f32": (torch.float32, 2, 256, 4, 1, 64, 128),
    "jamba-heads-bf16": (torch.bfloat16, 1, 192, 2, 1, 128, 128),
    "grouped-f32": (torch.float32, 1, 128, 8, 2, 32, 16),
    "partial-chunk-f32": (torch.float32, 2, 200, 2, 1, 16, 64),
    "tiny-bf16": (torch.bfloat16, 1, 5, 3, 1, 8, 8),
    "p8-one-slice-bf16": (torch.bfloat16, 2, 300, 8, 2, 8, 16),
    "under-one-chunk-f32": (torch.float32, 2, 40, 4, 1, 64, 128),
    "grouped-g4-ragged-bf16": (torch.bfloat16, 1, 1000, 8, 4, 32, 128),
}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_cuda_ssd_scan_matches_plain_version(cuda, case):
    dtype, b, s, h, g, p, n = SSD_CASES[case]
    rng = np.random.default_rng(len(case))
    x = torch.from_numpy(rng.normal(0, 1, (b, s, h * p)).astype(
        np.float32)).to(cuda, dtype).reshape(b, s, h, p)
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h)).astype(
        np.float32)).to(cuda)
    a_log = torch.from_numpy(rng.uniform(-1, 1, h).astype(np.float32)).to(
        cuda)
    bc = torch.from_numpy(rng.normal(0, 1, (b, s, 2 * g * n)).astype(
        np.float32)).to(cuda, dtype)
    bm = bc[..., :g * n].reshape(b, s, g, n)     # strided views, not copies
    cm = bc[..., g * n:].reshape(b, s, g, n)
    ss.reset_launches()
    y, state = ss.ssd_scan_cuda(x, dt, a_log, bm, cm, final_state=True)
    want_y, want_state = ref.ssd_chunked_ref(x, dt, a_log, bm, cm, chunk=64)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == 1
    assert y.dtype == dtype and y.shape == x.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_copies_what_it_cannot_stage(cuda, dtype):
    """x and B/C whose rows are not 16-byte multiples apart are copied once
    and give the plain version's result."""
    rng = np.random.default_rng(9)
    b, s, h, g, p, n = 1, 130, 4, 2, 16, 8
    x = torch.from_numpy(rng.normal(0, 1, (b, s, h, p + 2)).astype(
        np.float32)).to(cuda, dtype)[..., :p]
    bm, cm = (torch.from_numpy(rng.normal(0, 1, (b, s, g, n + 2)).astype(
        np.float32)).to(cuda, dtype)[..., :n] for _ in range(2))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h)).astype(
        np.float32)).to(cuda)
    a_log = torch.from_numpy(rng.uniform(-1, 1, h).astype(np.float32)).to(
        cuda)
    assert not any(ss.tma_ready(t) for t in (x, bm, cm))
    y, state = ss.ssd_scan_cuda(x, dt, a_log, bm, cm, final_state=True)
    want_y, want_state = ref.ssd_chunked_ref(x, dt, a_log, bm, cm, chunk=65)
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)


def test_cuda_ssd_scan_op_matches_naive_recurrence(cuda):
    rng = np.random.default_rng(5)
    bh, s, p, n = 3, 256, 32, 16
    x, bm, cm = (torch.from_numpy(rng.normal(0, 1, shape).astype(
        np.float32)).to(cuda) for shape in ((bh, s, p), (bh, s, n),
                                            (bh, s, n)))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (bh, s)).astype(
        np.float32)).to(cuda)
    a_log = torch.from_numpy(rng.uniform(-1, 1, bh).astype(np.float32)).to(
        cuda)
    y = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=64, device=cuda)
    want = ref.ssd_scan_ref(x, dt, a_log, bm, cm)
    torch.testing.assert_close(y, want, rtol=5e-4, atol=5e-4)


def test_cuda_mamba_serving_smoke_matches_cpu(cuda):
    """mamba2-1.3b at smoke size through the ssd_scan kernel: the card's
    logits and greedy tokens equal the CPU's, with one launch a layer in
    each prefill and none in decode."""
    cfg = smoke_config("mamba2-1.3b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = {"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 48)).astype(np.int32)}
    sc = ServeConfig(batch=2, max_len=96, window=8, slack=1.2)
    outs = {}
    for dev in ("cpu", cuda):
        ss.reset_launches()
        eng = ServingEngine(cfg, params, sc, device=dev)
        outs[str(dev)] = eng.generate(prompts, n_tokens=20)
        if dev == cuda:
            assert ss.LAUNCHES["ssd_scan"] == cfg.n_layers
        logits, _ = T.prefill(eng.params, cfg,
                              {"tokens": torch.as_tensor(prompts["tokens"],
                                                         device=dev)}, 96)
        outs[str(dev)]["logits"] = logits.cpu()
    cpu, card = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(card["logits"], cpu["logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(card["tokens"].cpu().numpy(),
                                  cpu["tokens"].numpy())
    assert card["energy"]["steps"] == cpu["energy"]["steps"]


MOE_CASES = {
    # name: (MoEConfig fields, tokens, explicit capacity, forced routing)
    "dropless-shared": (dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                             d_ff_shared=64, capacity_factor=8.0), 64, None,
                        False),
    "drops-capacity-factor-1": (dict(n_experts=8, top_k=2, d_ff_expert=32,
                                     capacity_factor=1.0), 256, None, False),
    "two-groups": (dict(n_experts=8, top_k=2, d_ff_expert=32,
                        capacity_factor=1.0, dispatch_groups=2), 256, None,
                   False),
    "one-expert-capacity-8": (dict(n_experts=2, top_k=1, d_ff_expert=8,
                                   capacity_factor=1.0), 32, 8, True),
    "qwen2-moe-shape": (dict(n_experts=60, top_k=4, d_ff_expert=1408,
                             n_shared=4, d_ff_shared=5632), 512, None, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_cuda_apply_moe_matches_cpu(cuda, case):
    """apply_moe on the card against the CPU on the same weights and
    tokens, with the device in sync-debug mode "error": no step of it may
    wait for the device."""
    fields, t, capacity, forced = MOE_CASES[case]
    cfg = M.MoEConfig(**fields)
    d = 64 if fields["d_ff_expert"] < 1024 else 2048
    params = M.init_moe(torch.Generator().manual_seed(3), d, cfg,
                        torch.float32)
    if forced:
        params["router"] = torch.tensor([[10.0, -10.0]] * d)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (t, d))
                         .astype(np.float32))
    if forced:
        x = torch.ones((t, d))
    want, want_aux = M.apply_moe(params, x, cfg, capacity=capacity)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v)
                   else {kk: vv.to(cuda) for kk, vv in v.items()})
               for k, v in params.items()}
    xc = x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = M.apply_moe(on_card, xc, cfg, capacity=capacity)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)
    kept = (got.cpu().abs().amax(-1) > 0)
    np.testing.assert_array_equal(kept.numpy(),
                                  (want.abs().amax(-1) > 0).numpy())
    if forced:
        assert int(kept.sum()) == 8


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_cuda_moe_serving_smoke_matches_cpu(cuda, arch):
    """MoE archs at smoke size (jamba: Mamba, attention and MoE layers in
    one model) through the flash and SSD kernels: the card's logits and
    greedy tokens equal the CPU's, with one launch a layer of each kernel
    in each prefill."""
    cfg = smoke_config(arch, attn_impl_train="pallas")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = {"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 48)).astype(np.int32)}
    sc = ServeConfig(batch=2, max_len=96, window=8, slack=1.2)
    outs = {}
    for dev in ("cpu", cuda):
        fa.reset_launches()
        ss.reset_launches()
        eng = ServingEngine(cfg, params, sc, device=dev)
        outs[str(dev)] = eng.generate(prompts, n_tokens=20)
        if dev == cuda:
            mixers = [spec.mixer for spec in cfg.pattern] * cfg.n_repeats
            assert fa.LAUNCHES["flash_attention"] == mixers.count("attn")
            assert ss.LAUNCHES["ssd_scan"] == mixers.count("mamba")
        logits, _ = T.prefill(eng.params, cfg,
                              {"tokens": torch.as_tensor(prompts["tokens"],
                                                         device=dev)}, 96)
        outs[str(dev)]["logits"] = logits.cpu()
    cpu, card = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(card["logits"], cpu["logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(card["tokens"].cpu().numpy(),
                                  cpu["tokens"].numpy())
    assert card["energy"]["steps"] == cpu["energy"]["steps"]


# ------------------------------------------------------------- training ---

def _grad_inputs(ts, which):
    return [t.clone().requires_grad_(i == which) for i, t in enumerate(ts)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_refuses_a_call_that_needs_its_backward(
        cuda, dtype):
    """Its output is written through ctypes and would carry no gradient."""
    q = torch.randn((1, 2, 64, 64), device=cuda).to(dtype)
    fa.reset_launches()
    for which in range(3):
        with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
            fa.flash_attention_cuda(*_grad_inputs((q, q, q), which))
    assert fa.LAUNCHES["flash_attention"] == 0
    with torch.no_grad():
        out = fa.flash_attention_cuda(*(t.clone().requires_grad_()
                                        for t in (q, q, q)))
    assert out.grad_fn is None and fa.LAUNCHES["flash_attention"] == 1


def _ssd_grad_case(cuda, case, odd=False):
    """SSD_CASES' inputs as the model hands them in, with cotangents of y
    and the final state; ``odd`` cuts every input and dy from wider
    tensors, so that no row is 16 bytes from the next."""
    dtype, b, s, h, g, p, n = SSD_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    pad = 1 if odd else 0

    def dev(shape, cut, d=torch.float32):
        t = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        return t.to(cuda, d)[..., :cut]

    x = dev((b, s, h, p + pad), p, dtype)
    bc = dev((b, s, g, 2 * n + pad), 2 * n, dtype)
    bm, cm = bc[..., :n], bc[..., n:]
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h + pad)).astype(
        np.float32)).to(cuda)[..., :h]
    a_log = torch.from_numpy(rng.uniform(-1, 1, h).astype(np.float32)).to(
        cuda)
    dy = dev((b, s, h, p + pad), p)
    dstate = dev((b, h, p, n), n)
    return (x, dt, a_log, bm, cm), dy, dstate


SSD_BWD_TOL = 1e-4   # of each gradient's largest magnitude


def _grads_close(got, want):
    """Within SSD_BWD_TOL of the largest |value| of each plain gradient:
    float32 sums in another order (chunks of 64 rows against chunks of 64,
    heads summed in another order, da_log over every token)."""
    for name, a, w in zip(("dx", "ddt", "da_log", "dB", "dC"), got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert torch.isfinite(w).all(), name
        torch.testing.assert_close(
            a, w, rtol=0, atol=SSD_BWD_TOL * float(w.abs().max()) + 1e-30,
            msg=name)


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_cuda_ssd_scan_bwd_matches_plain_version(cuda, case):
    """The backward kernels against autograd of the plain chunked version
    on the card, over the forward's sweep; a bfloat16 backward is refused,
    naming its ROADMAP item."""
    ins, dy, dstate = _ssd_grad_case(cuda, case)
    if ins[0].dtype == torch.bfloat16:
        with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
            ss.ssd_scan_bwd_cuda(*ins, dy.bfloat16(), dstate)
        return
    ss.reset_launches()
    got = ss.ssd_scan_bwd_cuda(*ins, dy, dstate)
    want = ref.ssd_chunked_bwd_ref(*ins, dy, dstate, chunk=64)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 1}
    _grads_close(got, want)
    only_y = ss.ssd_scan_bwd_cuda(*ins, dy, None)
    _grads_close(only_y, ref.ssd_chunked_bwd_ref(*ins, dy, None, chunk=64))


def test_cuda_ssd_scan_bwd_reads_odd_strides(cuda):
    """Inputs and dy cut from wider tensors (rows not 16 bytes apart), read
    through the autograd Function: the same gradients as plain."""
    ins, dy, dstate = _ssd_grad_case(cuda, "partial-chunk-f32", odd=True)
    assert not any(ss.tma_ready(t) for t in (ins[0], ins[3], ins[4], dy))
    views = [t.detach().requires_grad_() for t in ins]   # strides kept
    assert views[0].stride() == ins[0].stride()
    ss.reset_launches()
    y, state = ss.ssd_scan_cuda(*views, final_state=True)
    got = torch.autograd.grad([y, state], views, [dy, dstate])
    assert ss.LAUNCHES == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    _grads_close(got, ref.ssd_chunked_bwd_ref(*ins, dy, dstate, chunk=64))


def test_cuda_ssd_scan_bwd_is_deterministic(cuda):
    """No atomics: two calls give the same bits."""
    ins, dy, dstate = _ssd_grad_case(cuda, "grouped-f32")
    first = ss.ssd_scan_bwd_cuda(*ins, dy, dstate)
    second = ss.ssd_scan_bwd_cuda(*ins, dy, dstate)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("arch,over", [("olmo-1b", {"attn_impl_train":
                                                    "pallas"})])
def test_cuda_loss_backward_through_a_kernel_raises(cuda, arch, over):
    cfg = smoke_config(arch, **over)
    params = tree_map(lambda t: t.requires_grad_(), T.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda))
    toks = torch.ones((2, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 15"):
        T.loss_fn(params, cfg, {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_cuda_mamba_train_step_matches_cpu(cuda, arch):
    """A Mamba layer trains on the card through the SSD kernels and their
    backward: smoke mamba2-1.3b and jamba (remat on) from the same weights.
    The first step's gradients within 5e-5 of each leaf's largest CPU
    magnitude (a_log's and dt_bias's are sums over every token with
    cancellation: on jamba's third layer the plain SSD on an H100 (700 W)
    is already 6.9e-6 of its largest from the CPU, the kernel 1.09e-5);
    over 2 AdamW steps (lr 1e-3) losses and norms within 1e-5 relative and
    weights within 1e-4: AdamW moves every weight by about lr whatever its
    gradient's size, so where a gradient lies near its eps (1e-8) the last
    bits, summed in another order on the card, move that weight's step by
    a visible share (a jamba weight by 6.9e-5 on an H100), and a tenth of
    one step bounds it.  The forward kernel runs twice a Mamba
    layer a step (once more in remat's recomputation), the backward once."""
    cfg = smoke_config(arch, remat=True)
    n_mamba = [spec.mixer for spec in cfg.pattern].count("mamba") \
        * cfg.n_repeats
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    out = {}
    for dev in ("cpu", cuda):
        p = params_from_numpy(tree_map(lambda t: t.numpy(), params), dev)
        leaves = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = T.loss_fn(leaves, cfg, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batches[0].items()})
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        ss.reset_launches()
        state = adamw_init(p, opt)
        metrics = []
        for b in batches:
            p, state, m = step(p, state, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()})
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
        out[str(dev)] = (metrics, p, dict(ss.LAUNCHES), grads)
    assert out["cpu"][2] == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    assert out[str(cuda)][2] == {"ssd_scan": 4 * n_mamba,
                                 "ssd_scan_bwd": 2 * n_mamba}
    for a, b in zip(out[str(cuda)][3], out["cpu"][3]):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=5e-5 * float(b.abs().max()) + 1e-30)
    np.testing.assert_allclose(out[str(cuda)][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(tree_leaves(out[str(cuda)][1]),
                    tree_leaves(out["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("micro", [1, 2])
def test_cuda_train_step_matches_cpu(cuda, micro):
    """olmo-1b at smoke size, 3 steps from the same weights: losses,
    gradient norms and weights on the card within 1e-5 of the CPU's
    (float32, summed in another order); no kernel wrapper launched."""
    cfg = smoke_config("olmo-1b", remat=True)
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt, num_microbatches=micro,
                           lr_fn=linear_warmup_cosine(1e-3, 2, 10))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    out = {}
    fa.reset_launches()
    for dev in ("cpu", cuda):
        p = params_from_numpy(tree_map(lambda t: t.numpy(), params), dev)
        state = adamw_init(p, opt)
        metrics = []
        for b in batches:
            p, state, m = step(p, state, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()})
            metrics.append([float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")])
        out[str(dev)] = (metrics, p)
    assert fa.LAUNCHES["flash_attention"] == 0
    np.testing.assert_allclose(out[str(cuda)][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(tree_leaves(out[str(cuda)][1]),
                    tree_leaves(out["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_cuda_nccl_int8_all_reduce_and_hierarchical_reduce(cuda, tmp_path):
    """``tests/test_distribution.py:81-92`` under NCCL: one rank's values
    come back within one quantization step; the hierarchical reduce over a
    (pod 1, data 1) mesh gives them back the same way (int8) or exactly
    (float)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3.0, (1000,))
                         .astype(np.float32)).to(cuda)
    with one_rank_group(tmp_path, "nccl"):
        out = int8_all_reduce(x, None)
        mesh = make_mesh({"pod": 1, "data": 1}, "cuda")
        hier = [hierarchical_grad_reduce({"w": x}, mesh,
                                         compress_cross_pod=c)["w"]
                for c in (True, False)]
    bound = float(x.abs().max()) / 127.0 + 1e-6
    assert out.device.type == "cuda"
    assert float((out - x).abs().max()) <= bound
    assert float((hier[0] - x).abs().max()) <= bound
    assert torch.equal(hier[1], x)


def test_cuda_sharded_olmo_prefill_launches_flash_a_layer(cuda, tmp_path):
    cfg = smoke_config("olmo-1b", attn_impl_train="pallas",
                       batch_axes=("data",))
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)).to(cuda)
    want, wcache = T.prefill(params, cfg, {"tokens": toks}, 72)
    with one_rank_group(tmp_path, "nccl"):
        mesh = make_mesh({"data": 1, "model": 1}, "cuda")
        msd = mesh_shape_dict(mesh)
        dp = distribute_tree(params, param_specs(cfg, params, msd), mesh)
        batch = {"tokens": toks}
        fa.reset_launches()
        got, gcache = T.prefill(dp, cfg, distribute_tree(
            batch, batch_specs(cfg, batch, msd), mesh), 72)
        assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
        nxt = {"tokens": want.argmax(-1).to(torch.int32)[:, None]}
        got2 = T.decode_step(dp, cfg, distribute_tree(
            nxt, batch_specs(cfg, nxt, msd), mesh)["tokens"], gcache)[0]
        got, got2 = got.full_tensor(), got2.full_tensor()
    want2 = T.decode_step(params, cfg, nxt["tokens"], wcache)[0]
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got2 - want2).abs().max()) <= 1e-5
