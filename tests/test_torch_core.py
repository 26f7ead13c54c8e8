"""The port's copies of the NumPy host layers are bit-identical to ``repro``'s.

``repro_torch.core`` and ``repro_torch.data.synth`` are copies, not imports,
of the reference modules; the same random inputs must give the same bits.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
import repro.core.sampling as rsamp
import repro.data.synth as rsynth
import repro_torch.core as tc
import repro_torch.core.sampling as tsamp
import repro_torch.data.synth as tsynth

SEEDS = [0, 1, 2]


def _same(a, b):
    """Dataclass / array / scalar equality, bit for bit (NaN == NaN)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b or (a != a and b != b)


def _blocks(mod, est, util, halfwidth, roofline=False):
    """``BlockInfo`` list of ``mod``; every other block has a roofline model
    when ``roofline``."""
    return [mod.BlockInfo(
        i, float(e), est_rel_halfwidth=float(h), util=float(u),
        roofline=mod.RooflineTimeModel.from_counts(
            flops=1e12 * (1 + i), hbm_bytes=4e10 * (1 + i % 3),
            coll_bytes=1e8) if roofline and i % 2 == 0 else None)
        for i, (e, u, h) in enumerate(zip(est, util, halfwidth))]


def _random_blocks(seed, n=48):
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, 1.0, n), rng.uniform(0.3, 1.0, n),
            rng.uniform(0.0, 0.2, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_uniform_bit_identical(seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 10 ** 6, (17, 1))
    slots = rng.integers(0, 2 ** 20, (1, 33))
    for domain in (0, tsamp._DOMAIN_SAMPLER):
        _same(rsamp._hash_uniform(seed, blocks, slots, domain=domain),
              tsamp._hash_uniform(seed, blocks, slots, domain=domain))
    assert tsamp._DOMAIN_SAMPLER == rsamp._DOMAIN_SAMPLER
    assert tsamp._z_for_confidence(0.95) == rsamp._z_for_confidence(0.95)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", ["batched", "exact"])
def test_sample_blocks_soa_bit_identical(seed, method):
    rng = np.random.default_rng(seed)
    costs = rng.gamma(2.0, 1.0, (9, 120))
    lengths = rng.integers(0, 121, 9)
    for lens in (None, lengths):
        kw = dict(fraction=0.1, min_samples=4, n_boot=20, seed=seed,
                  start_index=5, method=method)
        _same(rc.sample_blocks_soa(costs, lens, **kw),
              tc.sample_blocks_soa(costs, lens, **kw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("planner", ["paper", "global", "roofline"])
@pytest.mark.parametrize("slack", [1.05, 1.3])
def test_plan_and_simulate_bit_identical(seed, planner, slack):
    est, util, hw = _random_blocks(seed)
    roof = planner == "roofline"
    rb = _blocks(rc, est, util, hw, roofline=roof)
    tb = _blocks(tc, est, util, hw, roofline=roof)
    deadline = float(est.sum()) * slack
    for power in ("CPU_PAPER_POWER", "TPU_V5E_POWER"):
        rpa = rc.plan_dvfs_arrays(rc.BlockArrays.from_blocks(rb), deadline,
                                  planner=planner,
                                  power=getattr(rc, power),
                                  adaptive_margin=seed == 1)
        tpa = tc.plan_dvfs_arrays(tc.BlockArrays.from_blocks(tb), deadline,
                                  planner=planner,
                                  power=getattr(tc, power),
                                  adaptive_margin=seed == 1)
        _same(rpa, tpa)
        truth_r = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax * 1.03)
                   for b in rb]
        truth_t = [dataclasses.replace(b, est_time_fmax=b.est_time_fmax * 1.03)
                   for b in tb]
        _same(rc.simulate(rpa.to_schedule_plan(), truth_r,
                          power=getattr(rc, power)),
              tc.simulate(tpa.to_schedule_plan(), truth_t,
                          power=getattr(tc, power)))


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_dvo_bit_identical(seed):
    est, util, hw = _random_blocks(seed)
    deadline = float(est.sum()) * 1.2
    rb, tb = _blocks(rc, est, util, hw), _blocks(tc, est, util, hw)
    _same(rc.plan_dvo_arrays(rc.BlockArrays.from_blocks(rb), deadline,
                             power=rc.CPU_PAPER_POWER),
          tc.plan_dvo_arrays(tc.BlockArrays.from_blocks(tb), deadline,
                             power=tc.CPU_PAPER_POWER))
    _same(rc.simulate(rc.plan_dvo(rb, deadline), rb),
          tc.simulate(tc.plan_dvo(tb, deadline), tb))
    _same(rc.simulate(rc.plan_dvfs(rb, deadline, planner="paper"), rb),
          tc.simulate(tc.plan_dvfs(tb, deadline, planner="paper"), tb))


@pytest.mark.parametrize("seed", SEEDS)
def test_energy_variety_and_synth_bit_identical(seed):
    _same(rc.zipf_weights(20, 0.5 * seed), tc.zipf_weights(20, 0.5 * seed))
    _same(rc.zipf_block_sizes(8, 1000, z=1.0, seed=seed),
          tc.zipf_block_sizes(8, 1000, z=1.0, seed=seed))
    vals = np.random.default_rng(seed).gamma(2.0, 1.0, 30)
    _same(rc.variety_stats(vals), tc.variety_stats(vals))
    _same(rc.DEFAULT_LADDER, tc.DEFAULT_LADDER)
    _same(rc.CPU_PAPER_POWER, tc.CPU_PAPER_POWER)
    mix = np.random.default_rng(seed).dirichlet(np.ones(4))
    _same(rsynth.make_corpus_block(64, 32, 1000, mix,
                                   rng=np.random.default_rng(seed)),
          tsynth.make_corpus_block(64, 32, 1000, mix,
                                   rng=np.random.default_rng(seed)))
