"""The port's optimizer, clipping and LR schedules against the JAX
package's, on the same seeded NumPy trees.

``adamw_update`` over 3 steps (float32 and bfloat16 moments, with and
without an lr override) holds parameters and moments within 1e-6 (float32
arithmetic in another order; a bfloat16 moment within one bfloat16 ulp,
2**-8 relative) and the int32 step exactly; ``clip_by_global_norm`` within
1e-6; both schedules within 3e-7 relative (two float32 ulps: XLA's and
torch's cos differ in the last place) of the reference's at every step of
their range.  The update is functional: the trees it is given are left
as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro_torch import optim as to
from repro_torch.models.convert import flatten, params_from_numpy


def _tree(rng):
    """A tree of the model's kinds of leaves: matrices (decayed), a stacked
    tensor, vectors and a scalar (not decayed)."""
    return {"w": rng.normal(0, 1, (8, 6)).astype(np.float32),
            "blocks": ({"wi": rng.normal(0, 1, (3, 6, 4)).astype(np.float32),
                        "scale": rng.normal(1, 0.1, 6).astype(np.float32)},),
            "b": rng.normal(0, 1, 5).astype(np.float32),
            "s": np.float32(rng.normal())}


def _close(got, want, tol):
    want = {k: np.asarray(v, np.float32) for k, v in
            flatten(jax.tree.map(np.asarray, want)).items()}
    got = flatten(got)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k],
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("lr", [None, 1e-2])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments, lr):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jc = jo.AdamWConfig(lr=3e-3, moment_dtype=moments)
    tc = to.AdamWConfig(lr=3e-3, moment_dtype=moments)
    jp, tp = jax.tree.map(jnp.asarray, p0), params_from_numpy(p0, "cpu")
    js, ts = jo.adamw_init(jp, jc), to.adamw_init(tp, tc)
    assert ts["m"]["w"].dtype == {"float32": torch.float32,
                                  "bfloat16": torch.bfloat16}[moments]
    for g in grads:
        before = {k: v.clone() for k, v in flatten(tp).items()}
        tlr = None if lr is None else torch.tensor(lr, dtype=torch.float32)
        jp, js = jo.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jc,
                                 lr)
        tp2, ts = to.adamw_update(tp, params_from_numpy(g, "cpu"), ts, tc,
                                  tlr)
        assert all(torch.equal(before[k], v) for k, v in flatten(tp).items())
        tp = tp2
    _close(tp, jp, 1e-6)
    mtol = 2 ** -8 if moments == "bfloat16" else 1e-6
    _close(ts["m"], js["m"], mtol)
    _close(ts["v"], js["v"], mtol)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3 == \
        int(js["step"])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(1))
    jg, jn = jo.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = to.clip_by_global_norm(params_from_numpy(g, "cpu"), max_norm)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(jo.global_norm(jg)),
                               float(to.global_norm(tg)), rtol=1e-6)
    _close(tg, jg, 1e-6)


@pytest.mark.parametrize("schedule,args", [
    ("cosine_schedule", (1e-3, 50)), ("cosine_schedule", (3e-4, 1, 0.0)),
    ("linear_warmup_cosine", (1e-3, 10, 100)),
    ("linear_warmup_cosine", (3e-4, 2, 12)),
    ("linear_warmup_cosine", (3e-4, 0, 5))])
def test_schedules_match_reference(schedule, args):
    jfn, tfn = getattr(jo, schedule)(*args), getattr(to, schedule)(*args)
    for step in range(0, 110):
        want = float(jfn(jnp.int32(step)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=3e-7, atol=1e-12,
                                   err_msg=f"step {step}")


def test_adamw_decreases_quadratic():
    """The reference's own check (tests/test_checkpoint_train.py), on the
    port."""
    cfg = to.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = to.adamw_init(params, cfg)
    for _ in range(200):
        params, state = to.adamw_update(params, {"w": 2 * params["w"]},
                                        state, cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state["step"]) == 200
