"""The port's bfloat16 train step against the JAX package's: the reference's
``train_4k`` cell at smoke size.

The reference's training cell (``src/repro/launch/dryrun.py:_lower_cell``,
train branch) steps bfloat16 weights (``launch/specs.py:params_shapes``)
with moments at ``cfg.opt_dtype`` through ``make_train_step(cfg, opt_cfg,
num_microbatches=...)``: one microbatch keeps bfloat16 gradients, more sum
them into float32 zeros.  Here both packages do so for the ten archs of
``tests/test_torch_train.py:LOSS_ARCHS`` (this file: the dense and
multimodal ones; ``test_torch_bf16_train_moe_ssm.py``: the MoE and Mamba
ones) at smoke size, with 1 and 2 microbatches: the reference's
``init_params(..., jnp.bfloat16)`` carried across by ``params_from_numpy``,
``AdamWConfig(lr=1e-3, moment_dtype=cfg.opt_dtype)`` on both sides, three
steps on seeded NumPy batches of 4 x 32 tokens (float32 patches for
pixtral).  The port runs the three steps twice:

* from the reference's state before each step (its weights and optimizer
  state carried across), so that each step is held alone: AdamW turns a
  rounding of a near-zero gradient into a whole ±lr move, after which the
  two runs train different weights;
* from its own state, three steps in a row: its leaves keep their dtypes
  and its step counter counts.

Tolerances, each for its own quantity.  "Measured" is the largest over
seeds 4, 5 and 6, 1 and 2 microbatches and every step, on the CPU:

* Loss, relative, 5e-4 (measured 2.35e-4, mixtral's; run from its own
  state 1e-3, measured 1.87e-4): a mean of float32 cross-entropies of
  bfloat16 logits, which the two packages round in different places
  (``tests/test_torch_bf16_cells.py``: a few bfloat16 steps of the
  largest logit).
* Grad norm, relative, 4e-3 a layer (``GN_TOL``; measured 1.72e-3 on the
  one-layer archs): every gradient is bfloat16 (a float32 sum of
  bfloat16 ones past one microbatch), so each leaf carries its
  backward's roundings, which add up layer by layer.
* Weights, every element: within 2 lr plus one bfloat16 step of the
  leaf's largest |value| (measured 2.44 lr).  AdamW moves a weight by
  lr m̂ / (√v̂ + eps), and over the first three steps |m̂ / √v̂| ≤ 1.0003
  whatever the gradients (Cauchy-Schwarz at b1 0.9, b2 0.95), so one step
  from the same state moves the two packages' weights at most 2 lr apart
  (a near-zero bfloat16 gradient rounded to the other sign), and each
  side rounds its new weight to bfloat16 once.  A broad error would hide
  under that bound, so the elements past a tighter one, 0.5 lr plus a
  bfloat16 step of their own value (a move rounding alone cannot make:
  a flipped sign), are counted over the three steps and held under 0.5%
  of the elements (``TOL["flips"]``; measured 0.116%, mixtral's).  Run
  from its own state, three steps in a row, each weight is within 6 lr
  plus a step of its leaf's largest (measured 5.62 lr).
* Moments, relative L2 error of each leaf's and of the whole tree's
  (``TOL``): a moment is (1 - b) of a gradient (or its square) on top of
  the same history, so this holds each leaf's bfloat16 gradient.  It is
  held in L2 and not element by element: the gradients of ``a_log``,
  ``dt_bias``, ``d_skip`` and the router are sums over every token whose
  terms cancel to a small share of their size, so their largest
  elements carry errors of tens of bfloat16 steps.  Those float32 leaves
  are held at 0.15 (``TOL["sums"]``; measured m 0.092, v 0.094: the
  MoE router's and mamba's ``d_skip``).  Every other leaf, and the tree,
  is held at 0.08 (``TOL["m"]``, ``TOL["v"]``; measured m 0.026, v 0.039,
  qwen1.5-32b's attention biases and mamba2's ``conv_bbc``), so a leaf
  whose gradient is 10% off fails at step 0, where m is 0.1 of it (10%
  off) and v 0.05 of its square (21%): a copy of the port that scales
  one weight leaf's gradient by 1.1 (``blocks§0§attn§wq``, mamba2's
  ``blocks§0§mamba§wz``) fails every case of the dense, MoE and mamba2
  archs.  The MoE archs hold their ordinary leaves at 0.15 (m) and 0.12
  (v) (``WIDE_TOL``; measured 0.087, 0.063, mixtral's at step 2: a
  rounding that flips a token's expert moves its share of every
  gradient; at step 0 both MoE archs stay under 0.036), where v still
  catches that 10%.
* Dtypes, exactly: every weight the reference's (bfloat16, but the
  float32 ``a_log``, ``dt_bias``, ``d_skip`` and router), every moment
  ``opt_dtype`` (jamba's bfloat16), the step counter int32.

jamba-1.5-large-398b (eight layers) holds its grad norm at ``GN_TOL`` a
layer (measured 1.81e-2), its moments at 0.4 (m) and 0.5 (v) a leaf and
over the tree (measured 0.269, 0.364; tree 0.150, 0.185), with its four
float32 leaves of cancelling sums held only in the tree's (their own
reach 0.61 and 1.23), and its flipped weights under 3% (measured
1.28%); at these tolerances a 10% error in one leaf's gradient does not
show in jamba's moments.  The gap is the reference's own rounding, as
``tests/test_torch_bf16_cells.py`` found for its forward: XLA:CPU
expands the bfloat16 ``silu`` as 1 / (1 + exp(-x)) rounded after each op
(``jax.nn.silu``'s backward rounds likewise), and under ``jit`` keeps
float32 across fused ops.  The reference disagrees with itself: its grad
norm under ``jit`` and eager differs by 0.87% on the same weights and
batch (seed 4, 2 microbatches, step 0: 4.05996 and 4.09542).  With the
reference eager and its silu expansion, forward and backward bit for
bit, patched into the port, jamba's gaps fall to the other archs' level
(seed 6): grad norm 1.46e-3, a leaf's moments 0.069 (m) and 0.116 (v),
float32 leaves included, loss 2.8e-5; flipped weights 0.155% (seed 4,
where ``jit`` gives 1.24%).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.checkpoint.ckpt import _flatten as ckpt_flatten
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
import repro_torch.configs as tcfg
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from test_torch_bf16_cells import _f32, _step
from test_torch_train import _batch

DENSE_ARCHS = ("olmo-1b", "yi-6b", "minitron-8b", "qwen1.5-32b",
               "pixtral-12b", "musicgen-large")
LR = 1e-3
STEPS = 3
SEED = 4
B, S = 4, 32
LOSS_TOL = 5e-4
GN_TOL = 4e-3            # a layer
# moments' relative L2 a leaf: ordinary leaves (and the tree) "m", "v", the
# float32 leaves of cancelling sums "sums" (None: held in the tree alone);
# flipped weights' share
TOL = {"m": 0.08, "v": 0.08, "sums": 0.15, "flips": 0.005}
# wider where a rounding flips a token's experts (MoE) or the reference's
# own rounding shows (jamba): see the docstring
WIDE_TOL = {"mixtral-8x7b": {**TOL, "m": 0.15, "v": 0.12},
            "qwen2-moe-a2.7b": {**TOL, "m": 0.15, "v": 0.12},
            "jamba-1.5-large-398b": {"m": 0.4, "v": 0.5, "sums": None,
                                     "flips": 0.03}}
FREE_LR = 6              # three steps of at most 2 lr each
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip", "router")


def _dtype(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return jnp.asarray(a).dtype.name


def _own_steps(w: np.ndarray) -> np.ndarray:
    """One bfloat16 step at each element's own |value|."""
    a = np.abs(w)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _check_dtypes(tp, ts, jp, js, opt_dtype: str, steps: int) -> None:
    want = {k: _dtype(v) for k, v in ckpt_flatten(jp).items()}
    got = {k: _dtype(v) for k, v in flatten(tp).items()}
    assert got == want
    for key, dt in got.items():
        f32 = key.split("§")[-1] in FLOAT32_LEAVES
        assert dt == ("float32" if f32 else "bfloat16"), key
    for name in ("m", "v"):
        moments = {k: _dtype(v) for k, v in flatten(ts[name]).items()}
        assert moments.keys() == want.keys()
        assert set(moments.values()) == {opt_dtype}, name
        assert moments == {k: _dtype(v) for k, v in
                           ckpt_flatten(js[name]).items()}
    assert ts["step"].dtype == torch.int32
    assert int(ts["step"]) == int(js["step"]) == steps


def _check_weights(tp, jp, bound_lr: float, label: str) -> tuple:
    """Every weight within ``bound_lr`` lr plus one bfloat16 step of its
    leaf's largest |value|; returns (elements past 0.5 lr plus a step of
    their own value, elements)."""
    got, want = flatten(tp), ckpt_flatten(jp)
    past = total = 0
    for key, w in want.items():
        w, g = _f32(w), _f32(got[key])
        err = np.abs(g - w)
        step = _step(w) if got[key].dtype == torch.bfloat16 else 0.0
        bound = bound_lr * LR + step
        assert float(err.max()) <= bound, (
            f"{label} {key}: max |err| {float(err.max()):.4g} = "
            f"{float(err.max()) / LR:.2f} lr (bound {bound_lr} lr + "
            f"{step:.3g})")
        past += int((err > 0.5 * LR + _own_steps(w)).sum())
        total += err.size
    return past, total


def _check_moments(ts, js, tol: dict, label: str) -> None:
    """m and v of each leaf within ``tol[name]`` relative L2 of the
    reference's, the float32 leaves whose gradients are cancelling sums
    (``FLOAT32_LEAVES``) within ``tol["sums"]`` (if it is None, only
    within the whole tree's), and the whole tree within ``tol[name]``."""
    for name in ("m", "v"):
        got, want = flatten(ts[name]), ckpt_flatten(js[name])
        err2 = norm2 = 0.0
        for key, w in want.items():
            w, g = _f32(w), _f32(got[key])
            e2, n2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
            err2, norm2 = err2 + e2, norm2 + n2
            lim = (tol["sums"] if key.split("§")[-1] in FLOAT32_LEAVES
                   else tol[name])
            if lim is None:
                continue
            assert e2 <= lim ** 2 * n2, (
                f"{label} {name} {key}: relative L2 {math.sqrt(e2 / n2):.4g}"
                f" (tol {lim})")
        assert err2 <= tol[name] ** 2 * norm2, (
            f"{label} {name}: the tree's relative L2 "
            f"{math.sqrt(err2 / norm2):.4g} (tol {tol[name]})")


def check_bf16_train_steps(arch: str, micro: int) -> None:
    jc, tc = jcfg.smoke_config(arch), tcfg.smoke_config(arch)
    assert tc.opt_dtype == jc.opt_dtype
    jp = JT.init_params(jc, jax.random.PRNGKey(SEED), jnp.bfloat16)
    jo = JAdamWConfig(lr=LR, moment_dtype=jc.opt_dtype)
    to = AdamWConfig(lr=LR, moment_dtype=tc.opt_dtype)
    jstep = jax.jit(j_make_train_step(jc, jo, num_microbatches=micro))
    tstep = make_train_step(tc, to, num_microbatches=micro)
    js = j_adamw_init(jp, jo)
    own_p, own_s = _carry(jp), _carry(js)
    gn_tol = GN_TOL * tc.n_layers
    tol = WIDE_TOL.get(arch, TOL)
    rng = np.random.default_rng(SEED)
    past = total = 0
    for i in range(STEPS):
        batch = _batch(jc, rng, b=B, s=S)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tp, ts = _carry(jp), _carry(js)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, tb)
        own_p, own_s, om = tstep(own_p, own_s, tb)
        label = f"{arch}, {micro} microbatch(es), step {i}"
        assert set(tm) == set(jm) == {"loss", "grad_norm"}
        for key, rtol in (("loss", LOSS_TOL), ("grad_norm", gn_tol)):
            assert tm[key].dtype == torch.float32, key
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, err_msg=f"{label} {key}")
        np.testing.assert_allclose(float(om["loss"]), float(jm["loss"]),
                                   rtol=2 * LOSS_TOL,
                                   err_msg=f"{label}, own state, loss")
        _check_dtypes(tp, ts, jp, js, jc.opt_dtype, i + 1)
        n_past, n = _check_weights(tp, jp, 2, label)
        past, total = past + n_past, total + n
        _check_moments(ts, js, tol, label)
    assert past <= tol["flips"] * total, (
        f"{arch}: {past} of {total} weights moved past 0.5 lr plus a step "
        "of their own value")
    _check_dtypes(own_p, own_s, jp, js, jc.opt_dtype, STEPS)
    _check_weights(own_p, jp, FREE_LR, f"{arch}, {micro}, own state")


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_bf16_train_step_matches_reference(arch, micro):
    check_bf16_train_steps(arch, micro)
