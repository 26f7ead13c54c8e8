"""The port's block-statistics entries against the JAX package's.

The same NumPy inputs go through ``repro.kernels.ops.block_stats*`` (Pallas in
interpret mode) and ``repro_torch.kernels.ops.block_stats*`` with
``device="cpu"`` (the plain PyTorch version).  Counts agree exactly.  Mass is
exact below 2**24; above it the reference's float32 sum is inexact while the
port rounds the exact int64 sum once, so there the port must equal the NumPy
int64 sum cast to float32 and lie within rtol 1e-6 of JAX.  The CUDA kernel
itself is held against the plain version in ``test_torch_cuda.py``, which
imports no JAX so that it runs on the card's machine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import block_stats as bs
from repro_torch.kernels import ops

PAT = (17, 23, 5)


def _check(port, want, exact_mass=None):
    """port (torch) vs want (JAX): counts exact, mass exact below 2**24."""
    got = port.numpy()
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    if exact_mass is not None:
        np.testing.assert_array_equal(got[..., 2], exact_mass)
    if np.all(np.abs(want[..., 2]) < 2 ** 24):
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
    else:
        np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6)


@pytest.mark.parametrize("rows,length", [(128, 64), (256, 32), (64, 96),
                                         (100, 64), (7, 16), (257, 48),
                                         (130, 32)])
def test_block_stats_matches_jax(rows, length):
    rng = np.random.default_rng(rows * 1000 + length)
    toks = rng.integers(0, 50, (rows, length)).astype(np.int32)
    for r in range(0, rows, 5):
        toks[r, :3] = PAT
    got = ops.block_stats(toks, PAT, device="cpu")
    _check(got, jops.block_stats(jnp.asarray(toks), PAT, interpret=True))
    assert float(got[1]) >= len(range(0, rows, 5))


@pytest.mark.parametrize("nb,rmax,length", [(12, 96, 40), (5, 64, 24),
                                            (3, 130, 32)])
def test_block_stats_batched_ragged_poisoned(nb, rmax, length):
    """Rows past a block's length hold the pattern and must not count."""
    rng = np.random.default_rng(nb * 100 + rmax)
    lens = rng.integers(1, rmax + 1, nb)
    toks = np.zeros((nb, rmax, length), np.int32)
    for b in range(nb):
        toks[b, :lens[b]] = rng.integers(0, 50, (lens[b], length))
        toks[b, 0, :3] = PAT
        toks[b, lens[b]:, :3] = PAT
    got = ops.block_stats_batched(toks, lens, PAT, device="cpu")
    _check(got, jops.block_stats_batched(jnp.asarray(toks), jnp.asarray(lens),
                                         PAT, interpret=True))
    assert got.shape == (nb, 3) and bool((got[:, 1] >= 1).all())


@pytest.mark.parametrize("nb,r,length", [(6, 64, 32), (1, 5, 24), (1, 1, 16),
                                         (4, 3, 24), (1, 128, 24)])
def test_block_stats_batched_full_and_small(nb, r, length):
    """``lengths=None`` means every row; blocks smaller than one tile."""
    rng = np.random.default_rng(nb * 10 + r)
    toks = rng.integers(0, 50, (nb, r, length)).astype(np.int32)
    toks[:, 0, :3] = PAT
    _check(ops.block_stats_batched(toks, None, PAT, device="cpu"),
           jops.block_stats_batched(jnp.asarray(toks), None, PAT,
                                    interpret=True))


def test_block_stats_batched_single_block_ragged_length():
    rng = np.random.default_rng(3)
    toks = np.zeros((1, 40, 24), np.int32)
    toks[0, :17] = rng.integers(0, 50, (17, 24))
    toks[0, 0, :3] = PAT
    toks[0, 17:, :3] = PAT
    _check(ops.block_stats_batched(toks, [17], PAT, device="cpu"),
           jops.block_stats_batched(jnp.asarray(toks), jnp.asarray([17]), PAT,
                                    interpret=True))


def test_block_stats_pattern_longer_than_row():
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 50, (8, 2)).astype(np.int32)
    got = ops.block_stats(toks, PAT, device="cpu")
    _check(got, jops.block_stats(jnp.asarray(toks), PAT, interpret=True))
    assert float(got[1]) == 0.0
    bat = ops.block_stats_batched(toks[None], None, PAT, device="cpu")
    assert float(bat[0, 1]) == 0.0


def test_block_stats_lengths_clamp_like_the_mask():
    """0 and negative lengths select no row, above R every row."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 50, (5, 40, 16)).astype(np.int32)
    toks[:, :, :3] = PAT
    lens = np.array([0, 41, -3, 40, 1000], np.int32)
    got = ops.block_stats_batched(toks, lens, PAT, device="cpu")
    _check(got, jops.block_stats_batched(jnp.asarray(toks), jnp.asarray(lens),
                                         PAT, interpret=True))
    assert float(got[0].abs().sum()) == 0.0 and float(got[2].abs().sum()) == 0.0


def test_block_stats_mass_past_2_24_is_the_exact_sum():
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 32768, (2, 512, 256)).astype(np.int32)
    exact = toks.astype(np.int64).sum(axis=(1, 2)).astype(np.float32)
    assert exact.min() > 2 ** 24
    _check(ops.block_stats_batched(toks, None, PAT, device="cpu"),
           jops.block_stats_batched(jnp.asarray(toks), None, PAT,
                                    interpret=True), exact_mass=exact)
    _check(ops.block_stats(toks[0], PAT, device="cpu"),
           jops.block_stats(jnp.asarray(toks[0]), PAT, interpret=True),
           exact_mass=exact[0])


@pytest.mark.parametrize("pattern", [(7, 7), (3, 9, 3, 9), tuple(range(1, 41))])
def test_block_stats_overlapping_and_long_patterns(pattern):
    rng = np.random.default_rng(len(pattern))
    toks = rng.integers(0, 10, (3, 50, 64)).astype(np.int32)
    toks[:, ::4, :len(pattern)] = pattern
    toks[:, 1, :] = pattern[0]              # runs of one id overlap
    got = ops.block_stats_batched(toks, [50, 20, 3], pattern, device="cpu")
    _check(got, jops.block_stats_batched(
        jnp.asarray(toks), jnp.asarray([50, 20, 3]), pattern, interpret=True))
    assert float(got[0, 1]) > 0


def test_block_stats_non_contiguous_and_empty_input():
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.integers(0, 30, (20, 33, 5)).astype(np.int32))
    view = base.permute(2, 1, 0)            # (5, 33, 20), not contiguous
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        ops.block_stats_batched(view, None, (3, 4), device="cpu").numpy(),
        ops.block_stats_batched(view.contiguous(), None, (3, 4),
                                device="cpu").numpy())
    empty = ops.block_stats_batched(np.zeros((3, 0, 8), np.int32), None, PAT,
                                    device="cpu")
    assert empty.shape == (3, 3) and float(empty.abs().sum()) == 0.0


def test_wrappers_reject_bad_input_and_count_no_cpu_launch():
    bs.reset_launches()
    toks = np.zeros((2, 4, 8), np.int32)
    with pytest.raises(TypeError):
        ops.block_stats_batched(toks.astype(np.int64), device="cpu")
    with pytest.raises(ValueError):
        ops.block_stats(toks, device="cpu")          # rank 3 to the 2-D entry
    with pytest.raises(ValueError):
        ops.block_stats_batched(toks, [1, 2, 3], device="cpu")
    with pytest.raises(ValueError):
        ops.block_stats_batched(toks, None, (), device="cpu")
    ops.block_stats_batched(toks, device="cpu")
    ops.block_stats(toks[0], device="cpu")
    assert bs.LAUNCHES == {"block_stats": 0, "block_stats_batched": 0}


def test_default_device_raises_without_cuda(monkeypatch):
    """No quiet CPU run: without a CUDA device the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toks = np.zeros((2, 4, 8), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.block_stats_batched(toks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.block_stats(toks[0])


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_BUILT", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(bs.SOURCE)


@pytest.mark.parametrize("nb,rows,length", [(1, 2048, 256), (256, 103, 256),
                                            (256, 2048, 256), (4, 3, 24),
                                            (1, 1, 100000)])
def test_tile_rows_spreads_the_grid(nb, rows, length):
    t = bs.tile_rows(nb, rows, length)
    assert 1 <= t <= rows
    ctas = nb * -(-rows // t)
    assert ctas >= min(1024, nb * rows)
    assert t * length <= max(4096, length)
