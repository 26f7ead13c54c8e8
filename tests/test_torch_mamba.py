"""The port's SSD scan and Mamba-2 block against the JAX package's.

``ops.ssd_scan(device="cpu")`` runs the plain chunked version, the CPU path
of the ``ssd_scan`` kernel wrapper; it is held against the JAX op in
interpret mode (the Pallas kernel's body run on the CPU) and against the
naive recurrence, on the reference's own sweep (``tests/test_kernels.py``)
at its tolerances, 5e-4 float32 and 5e-2 bfloat16.  The block's functions
take the reference's weights (``params_from_numpy``) and the same seeded
NumPy inputs, and agree at 1e-5 in float32 (sums in another order).
Gradients: under grad the wrapper runs through its autograd Function, whose
CPU backward is autograd of the plain chunked version; its five gradients
(and the block's six, D-skip included) agree with ``jax.vjp`` of the
reference's ``_ssd_chunked`` within 1e-5 of each gradient's largest
magnitude (float32 sums in another order; up to 7e-7 on the CPU), and so
does ``ref.ssd_split_bwd_ref``, the split the CUDA backward makes (up to
3e-6 on the CPU, on da_log, a sum over every token).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.configs.base import LayerSpec as JLayerSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as JM
from repro.models import transformer as JT
import repro_torch.configs as tcfg
from repro_torch.configs.base import LayerSpec as TLayerSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_map

TOL = 1e-5


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ------------------------------------------------------------- the op ---

SWEEP = [(128, 16, 32, 32), (256, 32, 16, 64), (64, 8, 8, 64)]
DTYPES = [(jnp.float32, torch.float32, 5e-4),
          (jnp.bfloat16, torch.bfloat16, 5e-2)]


def _sweep_inputs(s, p, n, jdtype):
    """The reference test's inputs (test_kernels.py:test_ssd_scan_sweep)."""
    rng = np.random.default_rng(hash((s, p, n)) % 2**31)
    bh = 3
    x = jnp.asarray(rng.normal(0, 1, (bh, s, p)).astype(np.float32), jdtype)
    dt = jnp.asarray(rng.uniform(0.01, 0.5, (bh, s)), jnp.float32)
    a_log = jnp.asarray(rng.uniform(-1, 1, (bh,)), jnp.float32)
    bm = jnp.asarray(rng.normal(0, 1, (bh, s, n)).astype(np.float32), jdtype)
    cm = jnp.asarray(rng.normal(0, 1, (bh, s, n)).astype(np.float32), jdtype)
    return x, dt, a_log, bm, cm


@pytest.mark.parametrize("jdtype,tdtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("s,p,n,chunk", SWEEP)
def test_ssd_scan_op_matches_reference(s, p, n, chunk, jdtype, tdtype, tol):
    args = _sweep_inputs(s, p, n, jdtype)
    targs = [_to_torch(a, tdtype if a.dtype == jdtype else torch.float32)
             for a in args]
    y = ops.ssd_scan(*targs, chunk=chunk, device="cpu")
    assert y.dtype == tdtype and tuple(y.shape) == (3, s, p)
    kernel = jops.ssd_scan(*args, chunk=chunk, interpret=True)
    naive = jref.ssd_scan_ref(*args)
    for want in (kernel, naive):
        _close(y, want, tol)
    # the port's naive recurrence is the reference's, line for line
    _close(ref.ssd_scan_ref(*targs), naive, tol)


@pytest.mark.parametrize("case", ["s-not-multiple", "p-outside", "n-outside",
                                  "group-mismatch"])
def test_ssd_scan_refuses_what_it_cannot_take(case):
    rng = np.random.default_rng(0)
    bh, s, p, n = 2, 48, 16, 16
    if case == "p-outside":
        p = 24
    if case == "n-outside":
        n = 4
    x = torch.from_numpy(rng.normal(0, 1, (bh, s, p)).astype(np.float32))
    dt = torch.full((bh, s), 0.1)
    a_log = torch.zeros(bh)
    bm = torch.from_numpy(rng.normal(0, 1, (bh, s, n)).astype(np.float32))
    if case == "s-not-multiple":
        with pytest.raises(ValueError, match="multiple of chunk"):
            ops.ssd_scan(x, dt, a_log, bm, bm, chunk=32, device="cpu")
    elif case == "group-mismatch":   # H = 3 heads over G = 2 groups
        xm = x.new_zeros((1, s, 3, p))
        bg = x.new_zeros((1, s, 2, n))
        with pytest.raises(ValueError, match="multiple of G"):
            ss.ssd_scan_cuda(xm, dt.new_zeros((1, s, 3)), a_log.new_zeros(3),
                             bg, bg)
    else:
        with pytest.raises(ValueError, match="must be in"):
            ops.ssd_scan(x, dt, a_log, bm, bm, chunk=16, device="cpu")


def test_ssd_scan_op_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((1, 16, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.ssd_scan(z, np.zeros((1, 16), np.float32),
                     np.zeros(1, np.float32), z, z)


# --------------------------------------------------------- the block ---

def _ssd_inputs(rng, bsz, s, h, p, g, n):
    return (rng.normal(0, 1, (bsz, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (bsz, s, h)).astype(np.float32),
            rng.uniform(-1, 1, (h,)).astype(np.float32),
            rng.normal(0, 1, (bsz, s, g, n)).astype(np.float32),
            rng.normal(0, 1, (bsz, s, g, n)).astype(np.float32),
            rng.normal(0, 1, (h,)).astype(np.float32))


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (40, 64)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Grouped heads (G=2), y and the final state; S=30 makes the chunk
    step down to 6, S=40 < chunk takes the whole sequence as one chunk."""
    rng = np.random.default_rng(s)
    bsz, h, p, g, n = 2, 4, 8, 2, 16
    args = _ssd_inputs(rng, bsz, s, h, p, g, n)
    jc = JM.SSMConfig(d_model=16, d_state=n, head_dim=p, n_groups=g,
                      chunk=chunk)
    tc = TM.SSMConfig(d_model=16, d_state=n, head_dim=p, n_groups=g,
                      chunk=chunk)
    jy, jh = JM._ssd_chunked(*(jnp.asarray(a) for a in args), jc)
    ty, th = TM._ssd_chunked(*(torch.from_numpy(a) for a in args), tc)
    _close(ty, jy)
    _close(th, jh)


def _cotangents(rng, bsz, s, h, p, n, with_state):
    dy = rng.normal(0, 1, (bsz, s, h, p)).astype(np.float32)
    dstate = rng.normal(0, 1, (bsz, h, p, n)).astype(np.float32) \
        if with_state else np.zeros((bsz, h, p, n), np.float32)
    return dy, dstate


def _grad_close(got, want, tol=TOL):
    """Within ``tol`` of the gradient's largest reference magnitude."""
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("with_state", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8)])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_grads_match_reference(groups, s, chunk, with_state):
    """The Function's five gradients on the CPU against ``jax.vjp`` of the
    reference's ``_ssd_chunked`` with D = 0 (its D-skip term is added
    outside the kernel), for cotangents of y and, when ``with_state``, of
    the final state; S = 30 steps the chunk down to 6 on both sides."""
    rng = np.random.default_rng(10 * s + groups)
    bsz, h, p, n = 2, 4, 8, 16
    args = _ssd_inputs(rng, bsz, s, h, p, groups, n)[:5]
    dy, dstate = _cotangents(rng, bsz, s, h, p, n, with_state)
    jc = JM.SSMConfig(d_model=16, d_state=n, head_dim=p, n_groups=groups,
                      chunk=chunk)
    _, vjp = jax.vjp(lambda *a: JM._ssd_chunked(*a, jnp.zeros(h), jc),
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    y, state = ss.ssd_scan_cuda(*ins, chunk=chunk, final_state=True)
    assert y.grad_fn is not None and state.grad_fn is not None
    outs, cots = [y], [torch.from_numpy(dy)]
    if with_state:
        outs.append(state)
        cots.append(torch.from_numpy(dstate))
    got = torch.autograd.grad(outs, ins, cots)
    for g, w in zip(got, want):
        _grad_close(g, w)


BF16_TOL = 5e-2   # the module's bfloat16 tolerance (DTYPES)


@pytest.mark.parametrize("with_state", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (40, 64)])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_grads_match_reference_bf16(groups, s, chunk, with_state):
    """The same five gradients with x, B, C and dy in bfloat16 (dt, a_log
    and dstate float32), as the bfloat16 training cells differentiate a
    layer: the CPU route (autograd of ``ref.ssd_chunked_ref``, which
    upcasts to float32 inside) against ``jax.vjp`` of the reference's
    ``_ssd_chunked``, which upcasts too; each gradient in its input's
    dtype, within BF16_TOL of its largest magnitude (the two round the
    bfloat16 outputs and gradients at other places)."""
    rng = np.random.default_rng(20 * s + groups)
    bsz, h, p, n = 2, 4, 8, 16
    args = list(_ssd_inputs(rng, bsz, s, h, p, groups, n)[:5])
    dy, dstate = _cotangents(rng, bsz, s, h, p, n, with_state)
    low = (0, 3, 4)   # x, B, C
    jargs = [jnp.asarray(a, jnp.bfloat16 if i in low else jnp.float32)
             for i, a in enumerate(args)]
    jc = JM.SSMConfig(d_model=16, d_state=n, head_dim=p, n_groups=groups,
                      chunk=chunk)
    _, vjp = jax.vjp(lambda *a: JM._ssd_chunked(*a, jnp.zeros(h), jc),
                     *jargs)
    want = vjp((jnp.asarray(dy, jnp.bfloat16), jnp.asarray(dstate)))
    ins = [_to_torch(a, torch.bfloat16 if i in low else torch.float32)
           .requires_grad_() for i, a in enumerate(jargs)]
    y, state = ss.ssd_scan_cuda(*ins, chunk=chunk, final_state=True)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    outs, cots = [y], [_to_torch(jnp.asarray(dy, jnp.bfloat16),
                                 torch.bfloat16)]
    if with_state:
        outs.append(state)
        cots.append(torch.from_numpy(dstate))
    got = torch.autograd.grad(outs, ins, cots)
    for g, w, t in zip(got, want, ins):
        assert g.dtype == t.dtype
        _grad_close(g, w, BF16_TOL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (40, 64)])
def test_ssd_chunked_grads_match_reference(s, chunk):
    """The block's scan, D-skip included (``_ssd_chunked``), differentiated
    for cotangents of y and the final state: six gradients against the
    reference's."""
    rng = np.random.default_rng(s + 7)
    bsz, h, p, g, n = 2, 4, 8, 2, 16
    args = _ssd_inputs(rng, bsz, s, h, p, g, n)
    dy, dstate = _cotangents(rng, bsz, s, h, p, n, True)
    jc = JM.SSMConfig(d_model=16, d_state=n, head_dim=p, n_groups=g,
                      chunk=chunk)
    tc = TM.SSMConfig(d_model=16, d_state=n, head_dim=p, n_groups=g,
                      chunk=chunk)
    _, vjp = jax.vjp(lambda *a: JM._ssd_chunked(*a, jc),
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    y, state = TM._ssd_chunked(*ins, tc)
    got = torch.autograd.grad([y, state], ins, [torch.from_numpy(dy),
                                                torch.from_numpy(dstate)])
    for g_, w in zip(got, want):
        _grad_close(g_, w)


@pytest.mark.parametrize("bsz,s,h,g,p,n,with_state", [
    (2, 128, 4, 2, 8, 16, True),      # two whole chunks, grouped B/C
    (2, 130, 4, 1, 16, 16, True),     # a last chunk of two rows
    (1, 40, 2, 1, 64, 128, False),    # mamba2's head shape, under a chunk
    (1, 100, 2, 1, 128, 32, True),    # jamba's head dim, two column slices
    (1, 70, 6, 3, 32, 8, False),      # three groups of two heads
])
def test_ssd_split_bwd_matches_chunked_bwd(bsz, s, h, g, p, n, with_state):
    """The CUDA backward's split, in plain PyTorch, against autograd of the
    plain chunked version (whose chunk is the whole sequence here), on
    strided views as the model passes them."""
    rng = np.random.default_rng(s + p)
    x, dt, a_log, bm, cm, _ = (torch.from_numpy(a) for a in _ssd_inputs(
        rng, bsz, s, h, p, g, 2 * n))
    b_mat, c_mat = bm[..., :n], cm[..., n:]
    dy, dstate = (torch.from_numpy(a) for a in _cotangents(
        rng, bsz, s, h, p, n, with_state))
    dstate = dstate if with_state else None
    want = ref.ssd_chunked_bwd_ref(x, dt, a_log, b_mat, c_mat, dy, dstate,
                                   chunk=s)
    got = ref.ssd_split_bwd_ref(x, dt, a_log, b_mat, c_mat, dy, dstate)
    for a, w in zip(got, want):
        _grad_close(a, w.numpy())


def test_ssd_scan_takes_the_function_only_under_grad():
    """Without grad the call is the serving path, with no ``grad_fn`` and
    the same values; an unused output's gradient is zero, and with no
    cotangent at all every gradient is zero."""
    x, dt, a_log, bm, cm, _ = (torch.from_numpy(a) for a in _ssd_inputs(
        np.random.default_rng(5), 1, 16, 2, 8, 1, 8))
    ins = (x, dt, a_log, bm, cm)
    with torch.no_grad():
        y = ss.ssd_scan_cuda(*(t.clone().requires_grad_() for t in ins),
                             chunk=8)
    assert y.grad_fn is None
    torch.testing.assert_close(y, ss.ssd_scan_cuda(*ins, chunk=8),
                               rtol=0, atol=0)
    for i in range(len(ins)):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(ins)]
        y, state = ss.ssd_scan_cuda(*args, chunk=8, final_state=True)
        assert type(y.grad_fn).__name__ == "SsdScanBackward"
        (g,) = torch.autograd.grad(state.sum(), [args[i]])
        want = ref.ssd_chunked_bwd_ref(*ins, None, torch.ones_like(state),
                                       chunk=8)[i]
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    zeros = ref.ssd_chunked_bwd_ref(*ins, None, None, chunk=8)
    assert all(not z.any() for z in zeros)


def _block(seed=0, **kw):
    jc = JM.SSMConfig(d_model=32, d_state=16, head_dim=16, expand=2, chunk=8,
                      **kw)
    tc = TM.SSMConfig(d_model=32, d_state=16, head_dim=16, expand=2, chunk=8,
                      **kw)
    jp = JM.init_mamba(jax.random.PRNGKey(seed), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_train_prefill_decode_match_reference(groups):
    jc, tc, jp, tp = _block(n_groups=groups)
    rng = np.random.default_rng(groups)
    u = rng.normal(0, 1, (2, 20, jc.d_model)).astype(np.float32)
    jy, jh = JM.mamba_train(jp, jnp.asarray(u), jc)
    ty, th = TM.mamba_train(tp, torch.from_numpy(u), tc)
    _close(ty, jy)
    _close(th, jh)

    jo, jcache = JM.mamba_prefill(jp, jnp.asarray(u), jc)
    to, tcache = TM.mamba_prefill(tp, torch.from_numpy(u), tc)
    _close(to, jo)
    assert set(tcache) == set(jcache) == {"conv_x", "conv_bc", "ssm"}
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])

    # decode two tokens; the port's cache tensors are updated in place
    ssm = tcache["ssm"]
    for _ in range(2):
        v = rng.normal(0, 1, (2, 1, jc.d_model)).astype(np.float32)
        jd, jcache = JM.mamba_decode(jp, jnp.asarray(v), jcache, jc)
        td, tcache2 = TM.mamba_decode(tp, torch.from_numpy(v), tcache, tc)
        assert tcache2 is tcache and tcache["ssm"] is ssm
        _close(td, jd)
        for key in jcache:
            _close(tcache[key], jcache[key])


def test_prefill_short_prompt_pads_the_conv_cache():
    """A prompt shorter than d_conv - 1 left-pads the raw conv caches."""
    jc, tc, jp, tp = _block(seed=3)
    u = np.random.default_rng(3).normal(0, 1, (2, 2, jc.d_model)).astype(
        np.float32)
    _, jcache = JM.mamba_prefill(jp, jnp.asarray(u), jc)
    _, tcache = TM.mamba_prefill(tp, torch.from_numpy(u), tc)
    for key in jcache:
        _close(tcache[key], jcache[key])


def test_prefill_state_continues_decode():
    """prefill(s) then decode == train over s+1 (tests/test_mamba.py:67)."""
    _, tc, _, tp = _block(seed=1)
    rng = np.random.default_rng(2)
    bsz, s = 2, 16
    u = torch.from_numpy(rng.normal(0, 1, (bsz, s + 1, tc.d_model)).astype(
        np.float32))
    y_all, _ = TM.mamba_train(tp, u, tc)
    _, cache = TM.mamba_prefill(tp, u[:, :s], tc)
    y_next, _ = TM.mamba_decode(tp, u[:, s:s + 1], cache, tc)
    torch.testing.assert_close(y_all[:, s:s + 1], y_next, rtol=1e-4,
                               atol=1e-4)


def test_init_mamba_matches_reference_leaves():
    """Shapes of every leaf; the deterministic leaves take the reference's
    values (dt_bias from NumPy's default_rng(0), a_log, ones and zeros)."""
    jc = JM.SSMConfig(d_model=32, d_state=16, head_dim=16, n_groups=2)
    tc = TM.SSMConfig(d_model=32, d_state=16, head_dim=16, n_groups=2)
    jp = JM.init_mamba(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = TM.init_mamba(torch.Generator().manual_seed(0), tc, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    for key in ("a_log", "dt_bias", "d_skip", "norm_scale", "conv_bx",
                "conv_bbc"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    assert TM.mamba_flops(tc, 4096) == JM.mamba_flops(jc, 4096)


def test_init_mamba_cache_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_mamba_cache(2, TM.SSMConfig(d_model=32))


# ------------------------------------------------------ hybrid pattern ---

def _hybrid(mod_cfg, layer_spec):
    base = mod_cfg.smoke_config("olmo-1b")
    ssm = mod_cfg.smoke_config("mamba2-1.3b").ssm
    return base.replace(
        pattern=(layer_spec("mamba", "dense"), layer_spec("attn", "dense")),
        n_layers=4, ssm=ssm)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_hybrid_pattern_prefill_and_decode_match_reference(impl):
    jc = _hybrid(jcfg, JLayerSpec).replace(attn_impl_train=impl)
    tc = _hybrid(tcfg, TLayerSpec).replace(attn_impl_train=impl)
    assert jc.n_repeats == tc.n_repeats == 2
    jp = JT.init_params(jc, jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(1, jc.vocab, (2, 40)).astype(
        np.int32)
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, 48)
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks)}, 48)
    _close(tl, jl)
    nxt = toks[:, -1:]
    for _ in range(3):
        jd, jcache = JT.decode_step(jp, jc, jnp.asarray(nxt), jcache)
        td, tcache = TT.decode_step(tp, tc, torch.from_numpy(nxt), tcache)
        _close(td, jd)
        nxt = np.asarray(jnp.argmax(jd, axis=-1)).astype(np.int32)[:, None]
    assert tcache["pos"] == int(jcache["pos"]) == 43
    jh, _ = JT.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    th, _ = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    _close(th, jh)
