"""The port's flash attention and attention module against the JAX package's.

Kernel level: ``repro_torch.kernels.ops.flash_attention(device="cpu")`` (the
plain PyTorch version) against ``repro.kernels.ops.flash_attention`` (the
Pallas kernel in interpret mode), on the cases of ``tests/test_kernels.py``
at its tolerances (float32 2e-5, bfloat16 2e-2).  The CUDA kernel itself is
held against the plain version in ``tests/test_torch_cuda.py``.

Module level: ``attention_train`` (dense, chunked, wedge, pallas), decode,
the SWA ring buffer and the int8 KV cache, with the reference's weights
carried across by ``params_from_numpy``, at the tolerances of
``tests/test_attention.py`` (2e-5 for the full-sequence paths, 1e-5 for
decode).  The kernel has no backward, so a call that needs one is refused
on the CPU as on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as TA
from repro_torch.models.convert import params_from_numpy

B, S, D = 2, 64, 32


def _rand(rng, shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x, jd), torch.from_numpy(x).to(dtype)


def _tol(dtype):
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    return dict(rtol=t, atol=t)


def _assert_close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ----------------------------------------------------------- kernel level ---

@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("s,d,bq,bk", [(128, 64, 64, 64), (256, 32, 128, 64)])
def test_flash_attention_matches_pallas_f32(hq, hkv, s, d, bq, bk):
    rng = np.random.default_rng(hq * 100 + hkv * 10 + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(rng, (2, h, s, d)), torch.float32)
        for h in (hq, hkv, hkv))
    got = ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk,
                              device="cpu")
    want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                interpret=True)
    assert got.dtype == torch.float32 and got.shape == (2, hq, s, d)
    _assert_close(got, want, **_tol(torch.float32))


def test_flash_attention_matches_pallas_bf16():
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(rng, (2, h, 128, 64)), torch.bfloat16) for h in (4, 2, 2))
    got = ops.flash_attention(tq, tk, tv, block_q=64, block_k=64,
                              device="cpu")
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64,
                                interpret=True)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, **_tol(torch.bfloat16))


@pytest.mark.parametrize("swa", [32, 128])
def test_flash_attention_swa_matches_pallas(swa):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(rng, (1, 2, 256, 32)), torch.float32) for _ in range(3))
    got = ops.flash_attention(tq, tk, tv, swa_window=swa, block_q=64,
                              block_k=64, device="cpu")
    want = jops.flash_attention(jq, jk, jv, swa_window=swa, block_q=64,
                                block_k=64, interpret=True)
    _assert_close(got, want, **_tol(torch.float32))


def test_flash_attention_noncausal_matches_pallas():
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(rng, (1, 2, 128, 32)), torch.float32) for _ in range(3))
    got = ops.flash_attention(tq, tk, tv, causal=False, block_q=64,
                              block_k=64, device="cpu")
    want = jops.flash_attention(jq, jk, jv, causal=False, block_q=64,
                                block_k=64, interpret=True)
    _assert_close(got, want, **_tol(torch.float32))


@pytest.mark.parametrize("causal,swa", [(True, None), (True, 24),
                                        (False, None), (False, 24)])
def test_flash_attention_ref_matches_reference_ref(causal, swa):
    """The plain versions agree, transposed views included."""
    rng = np.random.default_rng(3)
    x = [_rand(rng, (2, 96, h, 16)) for h in (6, 3, 3)]
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in x), causal=causal,
        swa_window=swa)
    want = jref.flash_attention_ref(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in x), causal=causal,
        swa_window=swa)
    _assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,err", [
    (dict(hkv=4), ValueError),                    # Hq % Hkv
    (dict(block_q=48), ValueError),               # S % block_q
    (dict(block_k=96), ValueError),               # S % block_k
    (dict(d=48), ValueError),                     # unsupported head dim
    (dict(dtype=torch.float16), TypeError),       # unsupported dtype
    (dict(rank3=True), ValueError),
])
def test_flash_attention_refuses_what_it_cannot_run(kw, err):
    hkv, d = kw.get("hkv", 2), kw.get("d", 32)
    dtype = kw.get("dtype", torch.float32)
    q = torch.zeros((1, 6, 128, d), dtype=dtype)
    k = torch.zeros((1, hkv, 128, d), dtype=dtype)
    if kw.get("rank3"):
        q, k = q[0], k[0]
    with pytest.raises(err):
        ops.flash_attention(q, k, k, block_q=kw.get("block_q", 64),
                            block_k=kw.get("block_k", 64), device="cpu")


@pytest.mark.parametrize("window", [-1, -48])
def test_flash_attention_refuses_a_negative_window(window):
    """The reference's result for a negative window depends on its tile
    sizes (it masks every key), so both entries refuse one."""
    q = torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="negative"):
        ops.flash_attention(q, q, q, swa_window=window, block_q=8,
                            block_k=8, device="cpu")
    fa.reset_launches()
    with pytest.raises(ValueError, match="negative"):
        fa.flash_attention_cuda(q, q, q, swa_window=window)
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("window", [None, 0])
def test_flash_attention_no_window_matches_pallas(window):
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_rand(rng, (1, 2, 16, 16)), torch.float32) for _ in range(3))
    got = ops.flash_attention(tq, tk, tv, swa_window=window, block_q=8,
                              block_k=8, device="cpu")
    want = jops.flash_attention(jq, jk, jv, swa_window=window, block_q=8,
                                block_k=8, interpret=True)
    _assert_close(got, want, **_tol(torch.float32))
    _assert_close(fa.flash_attention_cuda(tq, tk, tv, swa_window=window),
                  want, **_tol(torch.float32))


def test_flash_attention_cpu_tensor_takes_plain_version_without_launch():
    fa.reset_launches()
    q = torch.randn(1, 2, 32, 16)
    out = fa.flash_attention_cuda(q, q, q)
    assert fa.LAUNCHES["flash_attention"] == 0
    torch.testing.assert_close(out, ref.flash_attention_ref(q, q, q))


# ----------------------------------------------------------- module level ---

def _x(rng, b=B, s=S, d=D):
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _params(dims_j, seed, qkv_bias=False):
    jp = JA.init_attention(jax.random.PRNGKey(seed), dims_j, jnp.float32,
                           qkv_bias=qkv_bias)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("swa", [None, 16])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 1)])
def test_attention_train_matches_reference(impl, nq, nkv, swa):
    jd, td = JA.AttnDims(D, nq, nkv, 8), TA.AttnDims(D, nq, nkv, 8)
    jp, tp = _params(jd, 0)
    jx, tx = _x(np.random.default_rng(0))
    jo, jk, jv = JA.attention_train(jp, jx, jd, swa_window=swa, impl=impl,
                                    chunk_q=16, chunk_k=16)
    to, tk, tv = TA.attention_train(tp, tx, td, swa_window=swa, impl=impl,
                                    chunk_q=16, chunk_k=16)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        _assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("swa", [None, 48])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4)])
def test_pallas_impl_matches_reference(nq, nkv, swa):
    """impl='pallas': the plain version of the CUDA kernel here, the Pallas
    kernel in interpret mode there (head dim 16, a size the kernel takes)."""
    jd, td = JA.AttnDims(D, nq, nkv, 16), TA.AttnDims(D, nq, nkv, 16)
    jp, tp = _params(jd, 11)
    jx, tx = _x(np.random.default_rng(11), s=128)
    jo, _, _ = JA.attention_train(jp, jx, jd, impl="pallas", swa_window=swa,
                                  chunk_q=64, chunk_k=64)
    to, _, _ = TA.attention_train(tp, tx, td, impl="pallas", swa_window=swa,
                                  chunk_q=64, chunk_k=64)
    _assert_close(to, jo, rtol=2e-5, atol=2e-5)
    dense, _, _ = TA.attention_train(tp, tx, td, impl="dense", swa_window=swa)
    torch.testing.assert_close(to, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nq,nkv,tp", [(4, 4, 8), (8, 2, 4), (8, 8, 8),
                                       (40, 40, 16)])
def test_tp_head_padding_matches_reference(nq, nkv, tp):
    d = 64
    jd, td = JA.AttnDims(d, nq, nkv, 8, tp=tp), TA.AttnDims(d, nq, nkv, 8,
                                                            tp=tp)
    assert (td.n_q_phys, td.n_kv_phys) == (jd.n_q_phys, jd.n_kv_phys)
    jp, tparams = _params(jd, 3, qkv_bias=True)
    jx, tx = _x(np.random.default_rng(1), d=d)
    jo, _, _ = JA.attention_train(jp, jx, jd, impl="dense")
    to, _, _ = TA.attention_train(tparams, tx, td, impl="dense")
    _assert_close(to, jo, rtol=1e-5, atol=1e-5)


def _decode_both(jd, td, jp, tp, jx, tx, steps, **cache_kw):
    jc = JA.init_attention_cache(B, 64, jd, jnp.float32, **cache_kw)
    tc = TA.init_attention_cache(B, 64, td, torch.float32, device="cpu",
                                 **cache_kw)
    swa = cache_kw.get("swa_window")
    jouts, touts = [], []
    for t in range(steps):
        o, jc = JA.attention_decode(jp, jx[:, t:t + 1], jc, jnp.int32(t), jd,
                                    swa_window=swa)
        jouts.append(o)
        o, tc = TA.attention_decode(tp, tx[:, t:t + 1], tc, t, td,
                                    swa_window=swa)
        touts.append(o)
    return jnp.concatenate(jouts, axis=1), torch.cat(touts, dim=1), jc, tc


def test_decode_matches_reference_and_train():
    jd, td = JA.AttnDims(D, 4, 2, 8), TA.AttnDims(D, 4, 2, 8)
    jp, tp = _params(jd, 1)
    jx, tx = _x(np.random.default_rng(2), s=10)
    jdec, tdec, _, _ = _decode_both(jd, td, jp, tp, jx, tx, 10)
    _assert_close(tdec, jdec, rtol=1e-5, atol=1e-5)
    train, _, _ = TA.attention_train(tp, tx, td, impl="dense")
    torch.testing.assert_close(tdec, train, rtol=1e-5, atol=1e-5)


def test_swa_ring_buffer_matches_reference():
    w = 8
    jd, td = JA.AttnDims(D, 4, 4, 8), TA.AttnDims(D, 4, 4, 8)
    jp, tp = _params(jd, 2)
    jx, tx = _x(np.random.default_rng(3), s=24)
    jdec, tdec, jc, tc = _decode_both(jd, td, jp, tp, jx, tx, 24,
                                      swa_window=w)
    assert tc["k"].shape[1] == w
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    _assert_close(tdec, jdec, rtol=1e-5, atol=1e-5)
    train, _, _ = TA.attention_train(tp, tx, td, swa_window=w, impl="dense")
    torch.testing.assert_close(tdec, train, rtol=1e-5, atol=1e-5)


def test_int8_kv_decode_matches_reference():
    jd, td = JA.AttnDims(D, 4, 4, 8), TA.AttnDims(D, 4, 4, 8)
    jp, tp = _params(jd, 4)
    jx, tx = _x(np.random.default_rng(4), s=16)
    jdec, tdec, jc, tc = _decode_both(jd, td, jp, tp, jx, tx, 16,
                                      kv_quant=True)
    np.testing.assert_array_equal(tc["k_q"].numpy(), np.asarray(jc["k_q"]))
    _assert_close(tdec, jdec, rtol=1e-5, atol=1e-5)
    train, _, _ = TA.attention_train(tp, tx, td, impl="dense")
    err = float((train - tdec).abs().max())
    assert 0 < err < 5e-2, err      # it IS quantized, within int8's budget


@pytest.mark.parametrize("kv_quant,swa", [(False, None), (True, None),
                                          (False, 8)])
def test_prefill_cache_then_decode_matches_reference(kv_quant, swa):
    jd, td = JA.AttnDims(D, 4, 2, 8), TA.AttnDims(D, 4, 2, 8)
    jp, tp = _params(jd, 5)
    jx, tx = _x(np.random.default_rng(5), s=12)
    _, jk, jv = JA.attention_train(jp, jx, jd, impl="dense", swa_window=swa)
    _, tk, tv = TA.attention_train(tp, tx, td, impl="dense", swa_window=swa)
    kw = dict(kv_quant=kv_quant, swa_window=swa)
    jc = JA.fill_attention_cache(
        JA.init_attention_cache(B, 16, jd, jnp.float32, **kw), jk, jv,
        swa_window=swa)
    tc = TA.fill_attention_cache(
        TA.init_attention_cache(B, 16, td, torch.float32, device="cpu", **kw),
        tk, tv, swa_window=swa)
    jo, _ = JA.attention_decode(jp, jx[:, -1:] * 0 + 0.5, jc, jnp.int32(12),
                                jd, swa_window=swa)
    to, _ = TA.attention_decode(tp, tx[:, -1:] * 0 + 0.5, tc, 12, td,
                                swa_window=swa)
    assert to.shape == (B, 1, D)
    _assert_close(to, jo, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("swa", [None, 20])
@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 32), (48, 16), (64, 64)])
def test_wedge_matches_reference(s, chunk, swa):
    """impl='wedge' at even (4, 2) and odd (3, 1: the all-pairs fallback)
    chunk counts, against the reference's wedge and the port's dense."""
    jd, td = JA.AttnDims(D, 4, 2, 8), TA.AttnDims(D, 4, 2, 8)
    jp, tp = _params(jd, 9)
    jx, tx = _x(np.random.default_rng(9), s=s)
    jo, _, _ = JA.attention_train(jp, jx, jd, impl="wedge", swa_window=swa,
                                  chunk_q=chunk)
    to, _, _ = TA.attention_train(tp, tx, td, impl="wedge", swa_window=swa,
                                  chunk_q=chunk)
    _assert_close(to, jo, rtol=2e-5, atol=2e-5)
    dense, _, _ = TA.attention_train(tp, tx, td, impl="dense", swa_window=swa)
    torch.testing.assert_close(to, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
def test_wedge_equals_chunked_bit_for_bit_when_causal(s, chunk, dtype):
    """Causal, no window, an even chunk count: the all-pairs schedule's
    pairs that the wedge skips are fully masked and come after the
    diagonal, so they leave the running max, sum and output as they were
    (alpha 1, weights 0) and both schedules give the same bits; the
    production cells' plain prefill takes the wedge for it."""
    td = TA.AttnDims(D, 4, 2, 8)
    _, tp = _params(JA.AttnDims(D, 4, 2, 8), 11)
    _, tx = _x(np.random.default_rng(11), s=s)
    tp = {k: v.to(dtype) for k, v in tp.items()}
    tx = tx.to(dtype)
    outs = [TA.attention_train(tp, tx, td, impl=impl, chunk_q=chunk,
                               chunk_k=chunk)[0]
            for impl in ("chunked", "wedge")]
    assert outs[0].dtype == dtype and torch.equal(outs[0], outs[1])


def _requires_grad(*ts):
    return [t.clone().requires_grad_() for t in ts]


def test_flash_attention_refuses_a_call_that_needs_its_backward():
    """The CUDA kernel has no backward; the CPU path refuses the same call,
    so neither device returns an output without a gradient."""
    q = torch.randn(1, 2, 32, 16)
    for grads in ((True, False, False), (False, True, False),
                  (False, False, True)):
        qkv = [t.clone().requires_grad_(g) for t, g in zip((q, q, q), grads)]
        with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
            fa.flash_attention_cuda(*qkv)
    with torch.no_grad():
        out = fa.flash_attention_cuda(*_requires_grad(q, q, q))
    assert out.grad_fn is None
    torch.testing.assert_close(out, ref.flash_attention_ref(q, q, q))
    _, tp = _params(JA.AttnDims(D, 4, 4, 16), 3)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    _, tx = _x(np.random.default_rng(3))
    with pytest.raises(NotImplementedError, match="no backward"):
        TA.attention_train(tp, tx, TA.AttnDims(D, 4, 4, 16), impl="pallas")


@pytest.mark.parametrize("tokens,kv,causal", [(64, 64, True), (1, 512, False),
                                              (128, 256, True)])
def test_attn_flops_match_reference(tokens, kv, causal):
    args = (4096, 32, 8, 128)
    assert TA.attn_flops(TA.AttnDims(*args), tokens, kv, causal=causal) == \
        JA.attn_flops(JA.AttnDims(*args), tokens, kv, causal=causal)
