"""The port's checkpoints: atomic, keep-K, torn writes skipped, and one
on-disk format with the JAX package's, so a checkpoint written by either
package loads in the other, exactly (float32, int32 and bfloat16 leaves,
the optimizer's int32 step, dicts and tuples).

bfloat16: the reference writes its ``ml_dtypes`` leaves as 2-byte void
arrays, which the port reads as bfloat16 bits; the port writes bfloat16 as
float32 (exact), which the reference casts back.  The reference cannot load
its own bfloat16 leaves (NumPy has no cast from void), so that direction is
checked on a tree without them as well.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro_torch import checkpoint as tck
from repro_torch.models.convert import flatten, params_from_numpy


def _np_tree(seed=0, bf16=True):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.normal(0, 1, (4, 8)).astype(np.float32),
            "b": {"c": np.arange(6, dtype=np.int32),
                  "d": (np.ones(3, np.float32),
                        rng.normal(0, 1, 2).astype(np.float32))},
            "step": np.int32(7)}
    if bf16:
        tree["m"] = rng.normal(0, 1, (3, 5)).astype(jnp.bfloat16)
    return tree


def _torch(tree):
    return params_from_numpy(tree, "cpu")


def _assert_equal(got, want):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(g, torch.Tensor):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), k
            g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        else:
            assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(np.asarray(g, np.float64),
                                      np.asarray(w, np.float64), err_msg=k)


def test_checkpoint_roundtrip(tmp_path):
    tree = _torch(_np_tree())
    tck.save_checkpoint(str(tmp_path / "ck"), tree, step=7, extra={"x": 1})
    like = {k: v for k, v in tree.items()}
    restored, step = tck.load_checkpoint(str(tmp_path / "ck"), like,
                                         device="cpu")
    assert step == 7
    assert isinstance(restored["b"]["d"], tuple)
    _assert_equal(restored, _np_tree())
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["complete"] and meta["extra"] == {"x": 1}
    assert meta["keys"] == sorted(flatten(tree))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".ckpt")]


def test_checkpoint_load_refuses_a_mismatch(tmp_path):
    tree = _torch(_np_tree(bf16=False))
    tck.save_checkpoint(str(tmp_path / "ck"), tree, step=1)
    bad = dict(tree, a=torch.zeros(4, 9))
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_checkpoint(str(tmp_path / "ck"), bad, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        tck.load_checkpoint(str(tmp_path / "ck"),
                            dict(tree, z=torch.zeros(1)), device="cpu")
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(str(tmp_path / "nope"), tree, device="cpu")


def test_checkpoint_torn_write_skipped(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=3, async_save=False)
    tree = _torch(_np_tree(bf16=False))
    mgr.save(tree, 10)
    mgr.save({k: v + 1 if k == "a" else v for k, v in tree.items()}, 20)
    # corrupt the newest (simulate crash mid-write)
    meta = tmp_path / "step_0000000020" / "meta.json"
    meta.write_text(json.dumps({"complete": False}))
    restored, step = mgr.restore_latest(tree, device="cpu")
    assert step == 10  # fell back to the older valid one
    assert torch.equal(restored["a"], tree["a"])


def test_checkpoint_keep_k(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(_torch(_np_tree()), s)
    assert mgr.steps() == [3, 4]
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore_latest(
        _torch(_np_tree()), device="cpu") is None


def test_async_save_writes_the_snapshot_taken_at_save(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=1, async_save=True)
    tree = _torch(_np_tree())
    want = {k: v.clone() for k, v in flatten(tree).items()}
    mgr.save(tree, 5)
    tree["a"].add_(1.0)          # the caller changes its tensor at once
    mgr.wait()
    restored, step = mgr.restore_latest(tree, device="cpu")
    assert step == 5
    assert all(torch.equal(flatten(restored)[k], v) for k, v in want.items())


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    src = _np_tree(1)
    tck.save_checkpoint(str(tmp_path / "ck"), _torch(src), step=3)
    like = jax.tree.map(lambda x: jnp.zeros_like(jnp.asarray(x)), src)
    restored, step = jck.load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 3
    assert restored["m"].dtype == jnp.bfloat16
    _assert_equal(jax.tree.map(np.asarray, restored), src)


@pytest.mark.parametrize("bf16", [True, False])
def test_reference_checkpoint_loads_in_the_port(tmp_path, bf16):
    src = _np_tree(2, bf16=bf16)
    jck.save_checkpoint(str(tmp_path / "ck"), jax.tree.map(jnp.asarray, src),
                        step=9)
    like = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v
            for k, v in _torch(src).items()}
    like["b"] = {"c": torch.zeros(6, dtype=torch.int32),
                 "d": (torch.zeros(3), torch.zeros(2))}
    restored, step = tck.load_checkpoint(str(tmp_path / "ck"), like,
                                         device="cpu")
    assert step == 9
    _assert_equal(restored, src)
    if not bf16:   # the reference reads its own checkpoint back too
        back, _ = jck.load_checkpoint(str(tmp_path / "ck"),
                                      jax.tree.map(jnp.asarray, src))
        _assert_equal(jax.tree.map(np.asarray, back), src)


def test_reference_manager_restores_the_port_managers_newest(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    trees = [_np_tree(s, bf16=False) for s in (3, 4, 5)]
    for i, t in enumerate(trees):
        mgr.save(_torch(t), 10 * (i + 1))
    mgr.wait()
    jm = jck.CheckpointManager(str(tmp_path), keep=2)
    restored, step = jm.restore_latest(jax.tree.map(jnp.asarray, trees[0]))
    assert step == 30 and jm.steps() == [20, 30]
    _assert_equal(jax.tree.map(np.asarray, restored), trees[2])
