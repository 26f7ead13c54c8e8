"""The five apps in the port against the JAX apps on the same block.

Integer outputs agree exactly; float group sums within rtol 1e-5, since the
port's ``index_add_`` adds in another order than XLA's scatter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as REF_APPS
from repro.data import BlockDataset
from repro_torch.apps import ALL_APPS, measure_block_seconds

BLOCKS = [dict(n_blocks=2, records_per_block=128, max_len=64, seed=1),
          dict(n_blocks=2, records_per_block=96, max_len=48, seed=5,
               variety_z=2.0)]


def _outputs(name, block):
    want = jax.jit(REF_APPS[name]().run)(
        {k: jnp.asarray(v) for k, v in block.items()})
    got = ALL_APPS[name]().run(block, device="cpu")
    if not isinstance(want, dict):
        want, got = {"out": want}, {"out": got}
    assert want.keys() == got.keys()
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("kw", BLOCKS)
@pytest.mark.parametrize("name", ["wordcount", "grep", "inverted_index"])
def test_integer_apps_exact(kw, name):
    block = BlockDataset(**kw).block(1)
    want, got = _outputs(name, block)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    if name == "grep":
        assert got["total"] == BlockDataset(**kw).stats(1).matches


@pytest.mark.parametrize("kw", BLOCKS)
@pytest.mark.parametrize("name", ["avg", "sum"])
def test_float_apps_within_rtol(kw, name):
    block = BlockDataset(**kw).block(0)
    want, got = _outputs(name, block)
    assert got["out"].dtype == np.float32
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5)


def test_grep_pattern_longer_than_row_gives_zero():
    toks = np.full((4, 2), 17, np.int32)
    out = ALL_APPS["grep"]().run({"tokens": toks}, device="cpu")
    assert int(out["total"]) == 0 and out["per_record"].shape == (4,)


def test_measure_block_seconds_on_cpu_and_device_rule(monkeypatch):
    block = BlockDataset(**BLOCKS[0]).block(0)
    for name, cls in ALL_APPS.items():
        t = measure_block_seconds(cls(), block, repeats=2, device="cpu")
        assert np.isfinite(t) and t > 0, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_block_seconds(ALL_APPS["sum"](), block)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALL_APPS["wordcount"]().run(block)
