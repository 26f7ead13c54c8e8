"""The port's transformer and configs against the JAX package's.

The reference's smoke-size weights (``repro.models.transformer.init_params``)
go through ``jax.tree.map(np.asarray, ...)`` and
``repro_torch.models.convert.params_from_numpy``; the same seeded NumPy
batch goes through both packages' ``prefill`` and ``decode_step``.  Logits
agree at 1e-5 (float32, summed in another order) for every attention +
dense-MLP arch: olmo-1b, minitron-8b, qwen1.5-32b (QKV bias, int8 KV),
yi-6b (GQA), pixtral-12b (patch frontend) and musicgen-large (codebooks),
with the chunked attention and with the kernel path (``"pallas"``, whose
plain version runs here); for mamba2-1.3b, whose SSD goes through the
``ssd_scan`` wrapper (its plain version here) whatever the attention impl;
and for the MoE archs qwen2-moe-a2.7b (shared experts), mixtral-8x7b (SWA)
and jamba-1.5-large-398b (Mamba, attention, dense and MoE layers in one
pattern), whose smoke configs are dropless.  ``forward`` also returns the
MoE aux term, summed over layers, at 1e-5.  Jamba's pre-norm hidden states
are held at 5e-5: its eight smoke layers grow them to |h| ≈ 14, and the
reference's own float32 forward lies 1.6e-5 to 2.3e-5 from a float64 run of
the same function on these inputs (seeds 1-3), so no float32 implementation
can meet 1e-5 there; its logits are held at 1e-5 like every arch's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.checkpoint.ckpt import _flatten as ckpt_flatten
from repro.models import transformer as JT
import repro_torch.configs as tcfg
from repro_torch.models import transformer as TT
from repro_torch.models.convert import flatten, params_from_numpy

ARCHS = ("olmo-1b", "minitron-8b", "qwen1.5-32b", "yi-6b", "pixtral-12b",
         "musicgen-large", "mamba2-1.3b", "qwen2-moe-a2.7b", "mixtral-8x7b",
         "jamba-1.5-large-398b")
B, S = 2, 64
FORWARD_TOL = {"jamba-1.5-large-398b": 5e-5}   # see the module docstring


def _batch(cfg, rng, seq=S):
    shape = (B, seq, cfg.n_codebooks) if cfg.n_codebooks else (B, seq)
    b = {"tokens": rng.integers(1, cfg.vocab, shape).astype(np.int32)}
    if cfg.frontend == "patch":
        b["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return b


def _both(arch, seed=1, **overrides):
    jc = jcfg.smoke_config(arch, **overrides)
    tc = tcfg.smoke_config(arch, **overrides)
    jp = JT.init_params(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _close(got: torch.Tensor, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    jc, tc, jp, tp = _both(arch, attn_impl_train=impl)
    batch = _batch(jc, np.random.default_rng(1))
    total = S + (jc.n_patches if jc.frontend == "patch" else 0)
    jl, jcache = JT.prefill(jp, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, total + 4)
    tl, tcache = TT.prefill(tp, tc, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, total + 4)
    _close(tl, jl)
    assert tcache["pos"] == int(jcache["pos"]) == total
    nxt = batch["tokens"][:, -1:]
    for _ in range(2):
        jd, jcache = JT.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        td, tcache = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        _close(td, jd)
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)[:, None]
    assert tcache["pos"] == int(jcache["pos"]) == total + 2


@pytest.mark.parametrize("arch", ("olmo-1b", "pixtral-12b", "musicgen-large",
                                  "mamba2-1.3b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"))
def test_forward_matches_reference(arch):
    jc, tc, jp, tp = _both(arch, seed=2)
    batch = _batch(jc, np.random.default_rng(2), seq=32)
    jh, jaux = JT.forward(jp, jc, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    th, aux = TT.forward(tp, tc, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (float(aux) > 0) == (jc.moe is not None)
    _close(aux, jaux)
    _close(th, jh, FORWARD_TOL.get(arch, 1e-5))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference_checkpoint_paths(arch):
    """Same leaves, keyed as the reference's checkpoints, of the same shapes
    and dtypes; random weights from the generator, not from JAX's keys."""
    jc, tc = jcfg.smoke_config(arch), tcfg.smoke_config(arch)
    want = {k: v.shape for k, v in ckpt_flatten(
        JT.init_params(jc, jax.random.PRNGKey(0))).items()}
    tp = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(v.shape) for k, v in flatten(tp).items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in flatten(tp).values())
    assert all(bool(torch.isfinite(v).all()) for v in flatten(tp).values())
    # one seed, one set of weights
    again = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flatten(tp).values(),
                                                 flatten(again).values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    jc, tc = jcfg.get_arch(arch), tcfg.get_arch(arch)
    for tokens, kv, mode in ((4096, None, "train"), (32768, None, "prefill"),
                             (128, 32768, "decode")):
        assert TT.model_flops(tc, tokens, kv, mode=mode) == \
            JT.model_flops(jc, tokens, kv, mode=mode)


def test_batch_axes_need_the_sharded_port():
    jc, tc, _, tp = _both("olmo-1b")
    batch = {"tokens": torch.ones((B, 8), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.forward(tp, tc.replace(batch_axes=("data",)), batch)


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    for make in ("get_arch", "smoke_config"):
        j = getattr(jcfg, make)(arch)
        t = getattr(tcfg, make)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_repeats == j.n_repeats
        assert t.param_count() == j.param_count()


def test_shape_cells_equal():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    for arch in jcfg.ARCH_IDS:
        assert [c.name for c in tcfg.applicable_cells(tcfg.get_arch(arch))] \
            == [c.name for c in jcfg.applicable_cells(jcfg.get_arch(arch))]


def test_params_from_numpy_keeps_the_tree_and_values():
    _, _, jp, tp = _both("qwen1.5-32b")
    want = ckpt_flatten(jp)
    got = flatten(tp)
    assert list(got) == list(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr)
    assert isinstance(tp["blocks"], tuple)


@pytest.mark.parametrize("call", ["init_params", "init_cache",
                                  "params_from_numpy"])
def test_default_device_raises_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.smoke_config("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "init_params":
            TT.init_params(cfg)
        elif call == "init_cache":
            TT.init_cache(cfg, 2, 16)
        else:
            params_from_numpy({"w": np.zeros(3, np.float32)})
