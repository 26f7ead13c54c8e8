"""The SSD split as the CUDA kernel splits it, and the wrapper's host side.

``repro_torch.kernels.ref.ssd_split_ref`` computes the SSD the way
``csrc/ssd_scan.cu`` does: 64-row chunks (the last one padded with dt = 0),
C B^T once per (batch, group, chunk), then each head in slices of
min(P, 64) head-dim columns that carry their own rows of the state.  It is
held against the JAX package's op (the Pallas kernel in interpret mode, B/C
repeated per head as the reference's ``ops.py`` repeats them), against its
naive recurrence, and against the port's ``ssd_chunked_ref`` and
``ssd_scan_ref``, at the reference's kernel tolerance (float32 5e-4,
bfloat16 5e-2, absolute plus relative).  The host-side arithmetic of
``kernels/ssd_scan.py`` (slices, chunks, scratch, CTAs, shared memory, the
16-byte staging rule) is checked here too; the kernels themselves run in
``tests/test_torch_cuda.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ss

CSRC = Path(ss.__file__).resolve().parent / "csrc"
F32_TOL = 5e-4
BF16_TOL = 5e-2


def _inputs(seed, b, s, h, g, p, n):
    """x, dt, a_log, B, C as numpy float32, in the reference test's
    ranges."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32),
            rng.uniform(-1, 1, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, n)).astype(np.float32),
            rng.normal(0, 1, (b, s, g, n)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rows(a, h):
    """(B, S, K, D) -> (B*h, S, D), groups repeated to their heads."""
    b, s, k, d = a.shape
    a = np.repeat(a, h // k, axis=2)
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


# (B, S, H, G, P, N): G in {1, 4}, P in {8, 64, 128}, N in {8, 128}, S in
# {5, 64, 200, 1000} at small B*H
CASES = [
    (1, 5, 4, 1, 8, 8),
    (1, 5, 4, 4, 128, 128),
    (2, 64, 2, 1, 64, 128),
    (1, 64, 4, 4, 8, 128),
    (1, 200, 4, 1, 128, 8),
    (2, 200, 4, 4, 64, 8),
    (1, 1000, 4, 1, 64, 128),
    (1, 1000, 4, 4, 8, 8),
]


def _jax_chunk(s):
    """A chunk that divides S, as the reference's op requires."""
    return next(c for c in (64, 40, s) if s % c == 0)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_split_matches_jax_reference(case):
    b, s, h, g, p, n = case
    x, dt, a_log, bm, cm = _inputs(sum(case), *case)
    y, state = ref.ssd_split_ref(*map(torch.from_numpy, (x, dt, a_log, bm,
                                                          cm)))
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    args = (jnp.asarray(_rows(x, h)),
            jnp.asarray(dt.transpose(0, 2, 1).reshape(b * h, s)),
            jnp.asarray(np.tile(a_log, b)), jnp.asarray(_rows(bm, h)),
            jnp.asarray(_rows(cm, h)))
    got = y.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, p)
    _close(got, jops.ssd_scan(*args, chunk=_jax_chunk(s), interpret=True),
           F32_TOL)
    _close(got, jref.ssd_scan_ref(*args), F32_TOL)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_split_matches_port_references(case):
    b, s, h, g, p, n = case
    args = tuple(map(torch.from_numpy, _inputs(sum(case) + 1, *case)))
    y, state = ref.ssd_split_ref(*args)
    want_y, want_state = ref.ssd_chunked_ref(*args, chunk=256)
    _close(y, want_y, F32_TOL)
    _close(state, want_state, F32_TOL)
    x, dt, a_log, bm, cm = args
    naive = ref.ssd_scan_ref(
        torch.from_numpy(_rows(x.numpy(), h)),
        dt.transpose(1, 2).reshape(b * h, s), a_log.repeat(b),
        torch.from_numpy(_rows(bm.numpy(), h)),
        torch.from_numpy(_rows(cm.numpy(), h)))
    _close(y.transpose(1, 2).reshape(b * h, s, p), naive, F32_TOL)


@pytest.mark.parametrize("p_slice", [8, 16, 32, 64])
def test_split_does_not_depend_on_the_slice(p_slice):
    """Slices carry independent rows of the state: any width gives the same
    y and state, bit for bit up to the order of one einsum."""
    args = tuple(map(torch.from_numpy, _inputs(3, 1, 130, 4, 2, 64, 16)))
    y, state = ref.ssd_split_ref(*args, p_slice=p_slice)
    y64, state64 = ref.ssd_split_ref(*args, p_slice=64)
    torch.testing.assert_close(y, y64, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state, state64, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("block", [1, 3, 1 << 40])
def test_chunked_ref_in_blocks_equals_one_chunk_at_a_time(monkeypatch,
                                                         block):
    """``ssd_chunked_ref`` takes its chunks ``SSD_REF_BLOCK // (B q q H)``
    at a time (at least one), carrying the state from block to block: one
    chunk a block (the plain loop), three (a last block that is short) and
    every chunk in one block give the same y and final state bit for bit,
    and its gradients agree within float32 rounding (the other tests hold
    the result against the references)."""
    b, s, h, g, p, n, chunk = 2, 200, 4, 2, 8, 16, 16   # 20 chunks of 10
    args = [torch.from_numpy(a) for a in _inputs(7, b, s, h, g, p, n)]
    dy = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, (b, s, h, p)).astype(np.float32))
    q = 10
    monkeypatch.setattr(ref, "SSD_REF_BLOCK", b * q * q * h)
    want = ref.ssd_chunked_ref(*args, chunk=chunk)
    want_grads = ref.ssd_chunked_bwd_ref(*args, dy, None, chunk=chunk)
    monkeypatch.setattr(ref, "SSD_REF_BLOCK", block * b * q * q * h)
    got = ref.ssd_chunked_ref(*args, chunk=chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for gg, wg in zip(ref.ssd_chunked_bwd_ref(*args, dy, None, chunk=chunk),
                      want_grads):
        torch.testing.assert_close(gg, wg, rtol=1e-5, atol=1e-5)


def test_split_bf16_matches_chunked():
    args = list(map(torch.from_numpy, _inputs(4, 1, 200, 4, 2, 64, 32)))
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    y, state = ref.ssd_split_ref(*args)
    want_y, want_state = ref.ssd_chunked_ref(*args, chunk=40)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    _close(y.float(), want_y.float(), BF16_TOL)
    _close(state, want_state, BF16_TOL)


def test_split_padded_rows_change_nothing():
    """A sequence cut short of a chunk gives the first rows and the state of
    that shorter sequence: the padding adds nothing and decays nothing."""
    x, dt, a_log, bm, cm = map(torch.from_numpy,
                               _inputs(5, 1, 100, 2, 1, 16, 8))
    y, state = ref.ssd_split_ref(x[:, :70], dt[:, :70], a_log, bm[:, :70],
                                 cm[:, :70])
    want_y, want_state = ref.ssd_chunked_ref(x[:, :70], dt[:, :70], a_log,
                                             bm[:, :70], cm[:, :70], chunk=70)
    _close(y, want_y, F32_TOL)
    _close(state, want_state, F32_TOL)


# ----------------------------------------------------- host arithmetic ---

@pytest.mark.parametrize("p", ss.SIZES)
def test_p_slice_divides_p(p):
    ps = ss.p_slice(p)
    assert p % ps == 0 and ps == min(p, 64) and ps % 8 == 0


@pytest.mark.parametrize("s,nc", [(1, 1), (5, 1), (64, 1), (65, 2),
                                  (1000, 16), (1024, 16)])
def test_chunks_and_scratch(s, nc):
    assert ss.n_chunks(s) == nc
    assert ss.scratch_shape(3, s, 4) == (3, 4, nc, 64, 64)


def test_ctas_at_the_serving_shape():
    # mamba2-1.3b prefill: (B, S, H, G, P) = (8, 1024, 64, 1, 64)
    assert ss.ctas(8, 1024, 64, 1, 64) == {"cb": 128, "scan": 512}
    assert ss.ctas(1, 512, 4, 1, 128)["scan"] == 8      # jamba heads
    assert ss.ctas(2, 300, 8, 2, 8)["scan"] == 16       # P = 8, one slice


def test_work_at_the_serving_shape():
    """1.18 M FMAs a chunk-head, 1.13x the recurrence's 4 P N a token-head;
    C B^T is counted once per group."""
    b, s, h, g, p, n = 8, 1024, 64, 1, 64, 128
    fmas = ss.fmas(b, s, h, g, p, n)
    assert fmas == 16 * b * h * (2 * 64 * p * n + 2048 * p) \
        + 16 * b * g * 64 * 64 * n
    bound_flops = 4 * p * n * b * s * h
    assert 1.13 < 2 * fmas / bound_flops < 1.14
    # C B^T once per head would be 64x that part of the work
    assert ss.fmas(b, s, h, h, p, n) - fmas == 16 * b * (h - g) * 64 * 64 * n


@pytest.mark.parametrize("p", ss.SIZES)
@pytest.mark.parametrize("n", ss.SIZES)
def test_shared_memory_fits_a_cta(p, n):
    smem = ss.smem_bytes(p, n)
    assert 0 < smem["scan"] <= ss.SMEM_LIMIT
    assert 0 < smem["cb"] <= ss.SMEM_LIMIT
    assert smem["scan"] % 16 == 0 and smem["cb"] % 16 == 0


def test_shared_memory_at_the_serving_shape():
    assert ss.smem_bytes(64, 128) == {"scan": 230912, "cb": 67584}


def test_source_constants_match_the_host():
    text = (CSRC / ss.SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("kL") == ref.SSD_CHUNK
    assert const("kPSlice") == ref.SSD_P_SLICE
    assert const("kMaxN") == max(ss.SIZES)


def test_source_keeps_float32_units_and_stages_asynchronously():
    text = (CSRC / ss.SOURCE).read_text()
    assert "cp.async.cg.shared.global" in text
    assert "ssd_cb_kernel" in text and "ssd_scan_kernel" in text
    for needle in (".tf32", "wgmma.", "mma.sync"):
        assert needle not in text


def _model_views(dtype, b=2, s=70, h=4, g=2, p=16, n=8):
    x = torch.zeros((b, s, h * p), dtype=dtype).reshape(b, s, h, p)
    bc = torch.zeros((b, s, 2 * g * n), dtype=dtype)
    return (x, bc[..., :g * n].reshape(b, s, g, n),
            bc[..., g * n:].reshape(b, s, g, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_views_are_staged_as_they_lie(dtype):
    """The model's views, and ``ops.ssd_scan``'s (1, S, BH, P) view of a
    (BH, S, P) tensor, are staged without a copy."""
    ops_view = torch.zeros((3, 64, 16), dtype=dtype).transpose(0, 1)[None]
    for t in (*_model_views(dtype), ops_view):
        assert ss.tma_ready(t)
        assert ss.prepare(t) is t


@pytest.mark.parametrize("make,ready", [
    (lambda: torch.zeros((2, 8, 4, 16)), True),
    (lambda: torch.zeros((2, 8, 4, 16)).transpose(1, 2).contiguous()
     .transpose(1, 2), True),
    (lambda: torch.zeros((2, 8, 4, 18))[..., :16], False),  # 72-byte rows
    (lambda: torch.zeros((2, 8, 4, 20))[..., :16], True),   # 80-byte rows
    (lambda: torch.zeros(2 * 8 * 4 * 16 + 1)[1:].reshape(2, 8, 4, 16), False),
    (lambda: torch.zeros((2, 8, 4, 16)).transpose(2, 3)[..., :4], False),
    (lambda: torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((1, 8, 4, 20), dtype=torch.bfloat16)[..., :16],
     False),                                                # 40-byte rows
    (lambda: torch.zeros((1, 8, 3, 24))[:, :, :1, :16], True),  # one head
])
def test_tma_ready_on_ssd_inputs(make, ready):
    assert ss.tma_ready(make()) == ready


def test_prepare_copies_what_cannot_be_staged():
    for t in (torch.zeros((2, 8, 4, 18))[..., :16],
              torch.zeros(2 * 8 * 4 * 16 + 1)[1:].reshape(2, 8, 4, 16)):
        c = ss.prepare(t)
        assert ss.tma_ready(c) and c.data_ptr() != t.data_ptr()
        assert torch.equal(c, t)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = tuple(map(torch.from_numpy, _inputs(6, 1, 40, 2, 1, 8, 8)))
    ss.reset_launches()
    y, state = ss.ssd_scan_cuda(*args, chunk=8, final_state=True)
    want_y, want_state = ref.ssd_chunked_ref(*args, chunk=8)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert ss.LAUNCHES["ssd_scan"] == 0


# ------------------------------------------------------------- backward --
# The host side of ``csrc/ssd_scan_bwd.cu`` (its kernels run in
# ``tests/test_torch_cuda.py``; its split, ``ref.ssd_split_bwd_ref``, in
# ``tests/test_torch_mamba.py``).

def test_bwd_source_constants_match_the_host():
    text = (CSRC / ss.BWD_SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("kL") == ref.SSD_BWD_CHUNK == 32
    assert const("kPSlice") == ref.SSD_P_SLICE
    assert (const("kRing"), const("kStages")) == ss.BWD_RING
    assert const("kMaxN") == max(ss.SIZES)
    assert const("kMaxCluster") == max(
        ss.bwd_cluster(h, 1) for h in range(1, 65))


@pytest.mark.parametrize("p", ss.SIZES)
@pytest.mark.parametrize("n", ss.SIZES)
def test_bwd_shared_memory_fits_a_cta(p, n):
    smem = ss.bwd_smem_bytes(p, n)
    assert 0 < smem["states"] <= ss.SMEM_LIMIT
    assert 0 < smem["chunk"] <= ss.SMEM_LIMIT
    assert smem["states"] % 16 == 0 and smem["chunk"] % 16 == 0


def test_bwd_two_chunk_ctas_an_sm_at_the_training_shape():
    """mamba2-1.3b's heads (P = 64, N = 128): two chunk CTAs share an SM's
    233,472 bytes (the runtime keeps 1 KiB of each CTA's); a chunk kernel
    of 64-row chunks holding three L x L matrices asked 184,096 bytes, one
    an SM."""
    smem = ss.bwd_smem_bytes(64, 128)
    assert smem == {"states": 49552, "chunk": 112544}
    assert 2 * (smem["chunk"] + 1024) <= 233472
    assert 4 * (smem["states"] + 1024) <= 233472


@pytest.mark.parametrize("h,g,cs", [(64, 1, 8), (8, 2, 4), (8, 4, 2),
                                    (6, 2, 1), (5, 1, 1), (24, 1, 8),
                                    (12, 1, 4), (2, 2, 1)])
def test_bwd_cluster_divides_the_heads_of_a_group(h, g, cs):
    assert ss.bwd_cluster(h, g) == cs
    assert (h // g) % cs == 0


@pytest.mark.parametrize("s,nc", [(1, 1), (5, 1), (32, 1), (33, 2),
                                  (256, 8), (1000, 32), (1024, 32)])
def test_bwd_chunks(s, nc):
    assert ss.bwd_n_chunks(s) == nc


def test_bwd_work_and_scratch_at_the_training_shape():
    """8 x 256 tokens at mamba2-1.3b's heads: 1.172x the bound's
    11.0625 P N FLOP a (token, head) (a design of 64-row chunks with whole
    L x L products: 1.63x), and 285 MB of scratch: the states at 32-row
    chunks take twice the 134 MB they take at 64-row chunks, dB and dC
    over clusters of 8 heads an eighth of the 134 MB that per-head dB and
    dC take."""
    b, s, h, g, p, n = 8, 256, 64, 1, 64, 128
    ratio = 2 * ss.bwd_fmas(b, s, h, p, n) / ss.backward_flops(b, s, h, p, n)
    assert 1.17 < ratio < 1.18
    assert ss.bwd_scratch_bytes(b, s, h, g, p, n) == 285229056
    nc64 = -(-s // 64)
    states, heads = 4 * 2 * b * h * nc64 * p * n, 4 * 2 * b * s * h * n
    assert states == heads == 134217728
    assert ss.bwd_scratch_bytes(b, s, h, g, p, n) == (
        2 * states + heads // 8 + 4 * b * ss.bwd_n_chunks(s) * h)


def test_bwd_bound_takes_each_product_at_its_operands_rate():
    """The backward's bound at the train_4k microbatch (8 x 4,096 tokens,
    mamba2-1.3b's heads): with float32 inputs every product at the float32
    rate, L = 8 (2.836602 ms); with bfloat16 inputs the products of two
    bfloat16 operands (4 P N and the causal pairs' (L + 1)(2 P + 3 N)) at
    the bfloat16 rate and those of the float32 states (6 P N + 4 P N / L)
    at the float32 rate, L = 31 (1.675807 ms), above its bytes' 0.255 ms."""
    from repro_torch.device import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
    from repro_torch.launch import ssd_bwd_timing as bt
    b, s, h, g, p, n = 8, 4096, 64, 1, 64, 128
    f32 = bt.bound(b, s, h, g, p, n, torch.float32)
    assert (f32["bound_chunk"], f32["flops_bf16"]) == (8, 0)
    assert f32["flops"] == ss.backward_flops(b, s, h, p, n)
    assert f32["bound_ms"] == pytest.approx(2.836602, abs=1e-6)
    bf16 = bt.bound(b, s, h, g, p, n, torch.bfloat16)
    tokens, L = b * s * h, 31
    assert bf16["bound_chunk"] == L and bf16["bound_by"] == "operations"
    assert bf16["flops_bf16"] == (4 * p * n + (L + 1) * (2 * p + 3 * n)) \
        * tokens
    f32_ops = (6 * p * n + 4 * p * n / L) * tokens
    assert bf16["flops"] == round(f32_ops + bf16["flops_bf16"])
    assert bf16["bound_ms"] == pytest.approx(
        1e3 * (f32_ops / F32_FLOPS + bf16["flops_bf16"] / BF16_FLOPS),
        rel=1e-12)
    assert bf16["bound_ms"] == pytest.approx(1.675807, abs=1e-6)
    assert bf16["bytes"] == 855638528
    assert 1e3 * bf16["bytes"] / HBM_BYTES_PER_S < bf16["bound_ms"]
    for L in (8, 30, 32):          # any other chunk takes longer
        assert bt.op_seconds(s, p, n, torch.bfloat16)[0] < (
            (6 * p * n + 4 * p * n / L) / F32_FLOPS
            + (4 * p * n + (L + 1) * (2 * p + 3 * n)) / BF16_FLOPS)


def test_bwd_source_sums_in_a_fixed_order_in_float32():
    """No atomics (two calls give the same bits), no tensor-core route,
    cp.async staging and the cluster's sums through distributed shared
    memory; both input types instantiated."""
    text = (CSRC / ss.BWD_SOURCE).read_text()
    for needle in ("atomicAdd", "atomicCAS", "atom.", "red.global", ".tf32",
                   "wgmma.", "mma.sync"):
        assert needle not in text
    for needle in ("__pipeline_memcpy_async", "map_shared_rank",
                   "launch<float>", "launch<__nv_bfloat16>"):
        assert needle in text


def test_bwd_wrapper_takes_cuda_tensors_only():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 40, 2, 8)).astype(np.float32))
    dt = torch.full((1, 40, 2), 0.1)
    a_log = torch.zeros(2)
    bm = torch.from_numpy(rng.normal(0, 1, (1, 40, 1, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.ssd_scan_bwd_cuda(x, dt, a_log, bm, bm, x)
