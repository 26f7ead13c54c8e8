"""The port on the card: each CUDA kernel against its plain version, and the
main path's card run against its CPU run.

Marked ``cuda`` and skipped where torch sees no CUDA device.  This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel and plain version agree exactly (counts, and mass as the exact int64
sum cast to float32).
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import ALL_APPS
from repro_torch.data import BlockDataset
from repro_torch.kernels import block_stats as bs
from repro_torch.kernels import ref
from repro_torch.pipeline import PipelineConfig, stream_estimates_tokens, \
    stream_plan

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
    }


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
