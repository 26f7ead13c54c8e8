"""The port's MoE FFN against the JAX package's.

``repro.models.moe.init_moe`` draws the weights; they go through
``jax.tree.map(np.asarray, ...)`` and ``params_from_numpy``, and the same
seeded NumPy tokens go through both ``apply_moe``.  Outputs and the aux term
agree at 1e-5 (float32, summed in another order): dropless, with capacity
drops (a capacity factor of 1.0, and an explicit capacity under routing
forced onto one expert, as ``tests/test_moe.py``), with two dispatch groups
and with the fallback to one group when the tokens do not split evenly,
with and without shared experts.  ``moe_flops`` is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy

TOL = 1e-5
D = 16

CASES = {
    # name: (MoEConfig fields, tokens, explicit capacity)
    "dropless": (dict(n_experts=4, top_k=2, d_ff_expert=16,
                      capacity_factor=8.0), 32, None),
    "drops-capacity-factor-1": (dict(n_experts=4, top_k=2, d_ff_expert=16,
                                     capacity_factor=1.0), 64, None),
    "drops-explicit-capacity": (dict(n_experts=6, top_k=3, d_ff_expert=8,
                                     capacity_factor=1.0), 40, 8),
    "two-groups": (dict(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=1.0, dispatch_groups=2), 64, None),
    "groups-do-not-split": (dict(n_experts=4, top_k=2, d_ff_expert=16,
                                 capacity_factor=1.0, dispatch_groups=3), 64,
                            None),
    "relu2-experts": (dict(n_experts=8, top_k=2, d_ff_expert=12,
                           mlp_kind="relu2", capacity_factor=1.25), 48, None),
    "top-1": (dict(n_experts=5, top_k=1, d_ff_expert=16,
                   router_aux_weight=1.0), 40, None),
}


def _both(fields, seed=0):
    jc, tc = JM.MoEConfig(**fields), TM.MoEConfig(**fields)
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, jc, jnp.float32)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _run(jc, tc, jp, tp, x, capacity=None):
    jo, ja = JM.apply_moe(jp, jnp.asarray(x), jc, capacity=capacity)
    to, ta = TM.apply_moe(tp, torch.from_numpy(x), tc, capacity=capacity)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL, atol=TOL)
    assert to.dtype == torch.float32 and ta.shape == ()
    return to.numpy(), np.asarray(jo)


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_reference(case, n_shared):
    fields, t, capacity = CASES[case]
    if n_shared:
        fields = dict(fields, n_shared=n_shared, d_ff_shared=24)
    x = np.random.default_rng(3).normal(0, 1, (t, D)).astype(np.float32)
    _run(*_both(fields), x, capacity)


def test_overflow_is_dropped_as_the_reference_drops_it():
    """Routing forced onto expert 0 and capacity 8: 8 of 32 tokens keep
    their slot, the rest come out zero (tests/test_moe.py:52-63)."""
    jc, tc, jp, tp = _both(dict(n_experts=2, top_k=1, d_ff_expert=8,
                                capacity_factor=1.0))
    router = np.tile(np.array([[10.0, -10.0]], np.float32), (D, 1))
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.ones((32, D), np.float32)
    got, want = _run(jc, tc, jp, tp, x, capacity=8)
    kept = np.any(np.abs(got) > 0, axis=-1)
    assert int(kept.sum()) == 8 and kept[:8].all()
    np.testing.assert_array_equal(kept, np.any(np.abs(want) > 0, axis=-1))


def test_drops_change_the_output():
    """The capacity-1.0 case really drops slots: a dropless run of the same
    weights and tokens differs, so the parity above covers the drop."""
    fields, t, _ = CASES["drops-capacity-factor-1"]
    x = np.random.default_rng(3).normal(0, 1, (t, D)).astype(np.float32)
    jc, tc, jp, tp = _both(fields)
    dropped, _ = _run(jc, tc, jp, tp, x)
    full, _ = _run(jc, tc, jp, tp, x, capacity=t)
    assert np.abs(dropped - full).max() > 1e-3


def test_init_moe_tree_matches_reference():
    fields = dict(n_experts=4, top_k=2, d_ff_expert=16, n_shared=2,
                  d_ff_shared=24)
    jc, tc = JM.MoEConfig(**fields), TM.MoEConfig(**fields)
    jp = JM.init_moe(jax.random.PRNGKey(0), D, jc, jnp.float32)
    tp = TM.init_moe(torch.Generator().manual_seed(0), D, tc, torch.float32)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp,
                        is_leaf=lambda t: isinstance(t, torch.Tensor)) == shapes
    assert tp["router"].dtype == torch.float32
    bf16 = TM.init_moe(torch.Generator().manual_seed(0), D, tc, torch.bfloat16)
    assert bf16["router"].dtype == torch.float32
    assert bf16["wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_flops_and_capacity_equal(case):
    fields, t, _ = CASES[case]
    jc, tc = JM.MoEConfig(**fields), TM.MoEConfig(**fields)
    for d, tokens in ((2048, 8192), (64, 7), (4096, 1)):
        assert TM.moe_flops(d, tc, tokens) == JM.moe_flops(d, jc, tokens)
        assert TM._capacity(tokens, tc) == JM._capacity(tokens, jc)


@pytest.mark.parametrize("axis", ["group_axis", "expert_axis"])
def test_mesh_axes_need_the_sharded_port(axis):
    fields = {**CASES["dropless"][0], axis: "data"}
    tc = TM.MoEConfig(**fields)
    tp = TM.init_moe(torch.Generator().manual_seed(0), D, tc, torch.float32)
    with pytest.raises(NotImplementedError, match="item 13"):
        TM.apply_moe(tp, torch.zeros((8, D)), tc)
