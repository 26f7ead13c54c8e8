"""The port's bfloat16 prefill and decode against the JAX package's.

The reference's production cells (``src/repro/launch/dryrun.py``) run
``prefill(..., dtype=bfloat16)`` on bfloat16 weights into a bfloat16
cache, then ``decode_step``.  Here both packages do so at smoke size
(B = 2, S = 32): the reference's ``init_params(..., jnp.bfloat16)`` carried
across by ``params_from_numpy``, the same seeded batch, for seven archs
with the chunked attention and with the kernel path (``"pallas"``: the
reference's Pallas kernel in interpret mode, the port's plain version).
The port's own ``init_params(dtype=torch.bfloat16)`` gives the
reference's leaf dtypes (``a_log``, ``dt_bias``, ``d_skip`` and the router
stay float32), and so do the two caches.

Tolerances are in bfloat16 steps: one step of a tensor is the spacing of
bfloat16 numbers at its largest |value| in the reference, 2**(e - 7) for a
largest |value| in [2**e, 2**(e + 1)).  The two packages round in
different places, and not only because sums run in another order:

* the reference's ``jax.nn.silu`` on bfloat16 is XLA:CPU's expansion of
  ``logistic`` as 1 / (1 + exp(-x)), rounded to bfloat16 after each of
  the negation, the exp, the add and the divide, which puts it up to 2.08
  steps from the exact value (mean 0.46 over N(0, 2) inputs); the port's
  ``F.silu`` is computed in float32 and rounded once (at most 0.5 steps);
* under ``jit`` XLA fuses elementwise chains and may keep float32 between
  ops (excess precision) where the port rounds each op to bfloat16.

Each Mamba block has three silus and each SwiGLU MLP one, so the gap
grows with the layers: with the reference's silu expansion patched into
the port and the reference run eagerly, smoke jamba's last logits differ by
1.25 steps instead of 5.25 (seed 1), and every one of its eight layers,
fed the reference's input, gives the reference's output within 0.5 steps.
A one-layer arch's logits lie within 2.5 steps of the reference's,
jamba's eight layers' within 5.5 (seed 1, both impls): the logits'
tolerance is 3 steps, plus one step for each layer past the first.  Cache
leaves are held element by element, where the drift of the hidden stream
shows undamped by the final norm and the head's sums: a one-layer arch's
lie within 0.8 steps, while jamba's grow layer by layer to 13.6 steps at
layer 3's float32 state and 10 at layer 4's values (with the silu patched
and the reference eager, 3.2 and 1.8).  A leaf written by layer i (from 0)
is held to 4 (i + 1) steps.  A greedy token may flip only where the
reference's top two logits lie within the logits' tolerance of each
other; flips are counted.
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
import repro_torch.configs as tcfg
from repro_torch.launch.cell_memory import DECODE_STEPS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import flatten, params_from_numpy

ARCHS = ("olmo-1b", "mamba2-1.3b", "qwen2-moe-a2.7b", "musicgen-large",
         "pixtral-12b", "jamba-1.5-large-398b", "mixtral-8x7b", "yi-6b",
         "minitron-8b")
B, S = 2, 32
BASE_STEPS = 3      # logits of a one-layer arch, see the module docstring
LAYER_STEPS = 4     # cache drift a layer, see the module docstring


def _steps(cfg) -> float:
    """The logits' tolerance, in steps."""
    return BASE_STEPS + cfg.n_layers - 1


def _leaf_steps(cfg, key: str) -> float:
    """A cache leaf's tolerance, in steps: the leaf at pattern position j
    holds the layers j, j + P, ... of the P-layer pattern, the last of them
    written by layer (n_repeats - 1) P + j."""
    j = int(key.split("§")[1])
    return LAYER_STEPS * ((cfg.n_repeats - 1) * len(cfg.pattern) + j + 1)


def _step(ref: np.ndarray) -> float:
    """One bfloat16 step at ``ref``'s largest |value|."""
    top = float(np.abs(ref).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check_close(name: str, got, want, steps: float) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, name
    err = float(np.abs(g - w).max()) if w.size else 0.0
    step = _step(w)
    assert err <= steps * step, (f"{name}: max |err| {err:.4g} is "
                                 f"{err / step:.2f} steps (tol {steps})")


def _check_argmax(name: str, got, want, steps: float) -> None:
    """Greedy tokens equal, but where the reference's top two logits lie
    within ``steps`` of each other."""
    g, w = _f32(got), _f32(want)
    flips = g.argmax(-1) != w.argmax(-1)
    top2 = np.sort(w, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert np.all(gap <= steps * _step(w), where=flips), (
        f"{name}: {int(flips.sum())} greedy token(s) flipped at a top-two "
        f"gap over {steps} steps")


def _batch(cfg, rng) -> dict:
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    b = {"tokens": rng.integers(1, cfg.vocab, shape).astype(np.int32)}
    if cfg.frontend == "patch":
        # float32 patches against bfloat16 weights: the reference's ``@``
        # promotes, and so must the port's product
        b["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return b


def _dtypes(tree) -> dict:
    return {k: str(v.dtype).removeprefix("torch.")
            for k, v in tree.items()}


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch, impl):
    jc = jcfg.smoke_config(arch, attn_impl_train=impl)
    tc = tcfg.smoke_config(arch, attn_impl_train=impl)
    steps = _steps(tc)
    jp = JT.init_params(jc, jax.random.PRNGKey(1), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = _dtypes(ckpt_flatten(jp))
    own = TT.init_params(tc, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    assert _dtypes(flatten(own)) == want
    assert _dtypes(flatten(tp)) == want
    assert "bfloat16" in want.values()

    batch = _batch(jc, np.random.default_rng(1))
    total = S + (jc.n_patches if jc.frontend == "patch" else 0)
    jl, jcache = JT.prefill(jp, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, total + 4,
                            dtype=jnp.bfloat16)
    tl, tcache = TT.prefill(tp, tc, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, total + 4,
                            dtype=torch.bfloat16)
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    _check_close("prefill logits", tl, jl, steps)
    _check_argmax("prefill", tl, jl, steps)
    assert tcache["pos"] == int(jcache["pos"]) == total
    jleaves = ckpt_flatten({"blocks": jcache["blocks"]})
    tleaves = flatten({"blocks": tcache["blocks"]})
    assert _dtypes(tleaves) == _dtypes(jleaves)
    assert "bfloat16" in _dtypes(tleaves).values()
    for key, want_leaf in jleaves.items():
        _check_close(f"cache {key}", tleaves[key], want_leaf,
                     _leaf_steps(tc, key))

    nxt = batch["tokens"][:, -1:]
    jd, jcache = JT.decode_step(jp, jc, jnp.asarray(nxt), jcache)
    td, tcache = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
    assert td.dtype == torch.bfloat16
    _check_close("decode logits", td, jd, steps)
    _check_argmax("decode", td, jd, steps)
    assert tcache["pos"] == int(jcache["pos"]) == total + 1


LONG_PROMPT = 100   # positions no 64-row chunk (nor the smoke chunk) divides


def test_bf16_long_cell_decode_matches_reference():
    """The long_500k cell's shape at smoke size: mamba2-1.3b in bfloat16, one
    row, a prefill of ``LONG_PROMPT`` positions into a cache
    ``DECODE_STEPS`` longer, then ``DECODE_STEPS`` decode steps up to the
    cache's last position, both packages fed the same tokens; the prefill's
    and every step's logits within the logits' tolerance, the final caches
    leaf by leaf within theirs."""
    jc = jcfg.smoke_config("mamba2-1.3b")
    tc = tcfg.smoke_config("mamba2-1.3b")
    steps = _steps(tc)
    jp = JT.init_params(jc, jax.random.PRNGKey(1), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    total = LONG_PROMPT + DECODE_STEPS
    tokens = np.random.default_rng(2).integers(
        1, jc.vocab, (1, total)).astype(np.int32)
    prompt = tokens[:, :LONG_PROMPT]
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(prompt)}, total,
                            dtype=jnp.bfloat16)
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(prompt)},
                            total, dtype=torch.bfloat16)
    _check_close("prefill logits", tl, jl, steps)
    for i in range(DECODE_STEPS):
        nxt = tokens[:, LONG_PROMPT + i:LONG_PROMPT + i + 1]
        jl, jcache = JT.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        tl, tcache = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        assert tl.dtype == torch.bfloat16
        _check_close(f"decode step {i} logits", tl, jl, steps)
        _check_argmax(f"decode step {i}", tl, jl, steps)
    assert tcache["pos"] == int(jcache["pos"]) == total
    jleaves = ckpt_flatten({"blocks": jcache["blocks"]})
    tleaves = flatten({"blocks": tcache["blocks"]})
    for key, want_leaf in jleaves.items():
        _check_close(f"cache {key}", tleaves[key], want_leaf,
                     _leaf_steps(tc, key))
