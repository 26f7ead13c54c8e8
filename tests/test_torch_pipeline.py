"""Token blocks → block stats → estimates → plan: the port against ``repro``.

Data is bitwise the reference's (NumPy generation).  Stats counts agree
exactly.  Estimates keep ``index`` and ``n_sampled`` exact and ``total`` and
the CI within rtol 1e-6: the reference sums mass in float32 inside its
kernel, the port sums it exactly, and the per-row sums run in another order.
Plans on those estimates pick the same frequency for every block.
"""
import numpy as np
import pytest

from repro.data import BlockDataset as RefDataset
from repro.pipeline import PipelineConfig as RefConfig
from repro.pipeline import stream_estimates as ref_stream_estimates
from repro.pipeline import stream_estimates_tokens as ref_tokens
from repro.pipeline import stream_plan as ref_plan
from repro.pipeline import synthetic_cost_chunks
from repro_torch.core import CPU_PAPER_POWER, EstimateArrays
from repro_torch.data import BlockDataset
from repro_torch.pipeline import (PipelineConfig, plan_estimates,
                                  stream_estimates, stream_estimates_tokens,
                                  stream_plan, stream_run,
                                  token_chunk_estimates)

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


def test_cluster_runtime_and_calibration_paths_not_ported():
    est = stream_estimates(np.ones((3, 8)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan_estimates(est, 10.0, nodes=[object()])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        plan_estimates(est, 10.0, power_cap_w=100.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stream_plan(est, 10.0, PipelineConfig(calibration=object()))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stream_run(est, 10.0, nodes=[object()])
