"""GQA attention: TP-aware head layout, RoPE, SWA, chunked (flash-style)
and wedge softmax, the CUDA flash-attention kernel, and decode with
(optionally int8) KV caches.

The port of ``src/repro/models/attention.py``; layouts and names follow it.
TP head layout:
  * MHA (hq == hkv) with hq % tp != 0 -> pad BOTH to the next multiple of tp;
    padded q heads have zero wq columns and zero wo rows (exact: their output
    contribution is zero), padded kv heads duplicate the first logical heads.
  * GQA (hkv < hq) -> require hq % tp == 0; duplicate kv heads by
    F = max(tp, hkv)/hkv (exact: each q group still reads its own logical kv
    head).

Caches are updated in place (the reference returns new arrays): decode and
prefill write into the tensors of the cache dict they are given.

On DTensors (a tensor-parallel layout, ``parallel.param_specs``) the
projections are DTensor products, and RoPE, the attention itself and the
cache writes run on each rank's (batch, head) shard under ``local_map``
(``parallel.shards.on_shards``): attention never mixes heads or sequences,
so the core needs no collective, and the flash kernel runs on each rank's
local heads.  A rank's q heads are contiguous, as are its kv heads, and
with ``AttnDims``'s padding and duplication both counts split evenly
whenever the kv heads do, so local q head j reads local kv head j // R,
the same logical head as in the unsharded layout.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.models.common import LeafShape, apply_rope, normal
from repro_torch.parallel.shards import head_roles, layout, mesh_of, on_shards

NEG_INF = -1e30

__all__ = ["AttnDims", "init_attention", "attention_train",
           "attention_decode", "attention_cache_shapes",
           "init_attention_cache", "fill_attention_cache", "attn_flops"]


@dataclasses.dataclass(frozen=True)
class AttnDims:
    """Logical + physical (TP-padded) head layout."""

    d_model: int
    n_q: int           # logical query heads
    n_kv: int          # logical kv heads
    d_head: int
    tp: int = 1

    @property
    def n_q_phys(self) -> int:
        if self.n_q % self.tp:
            if self.n_q != self.n_kv:
                raise ValueError("GQA archs must have n_q % tp == 0")
            return math.ceil(self.n_q / self.tp) * self.tp
        return self.n_q

    @property
    def n_kv_phys(self) -> int:
        if self.n_q % self.tp:  # MHA padding case: keep layout aligned with q
            return self.n_q_phys
        if self.n_kv >= self.tp:
            return math.ceil(self.n_kv / self.tp) * self.tp
        if self.tp % self.n_kv:
            raise ValueError(f"tp={self.tp} not a multiple of n_kv={self.n_kv}")
        return self.tp

    @property
    def rep_phys(self) -> int:
        assert self.n_q_phys % self.n_kv_phys == 0
        return self.n_q_phys // self.n_kv_phys

    def kv_logical_index(self, j: int) -> int:
        """Which logical kv head physical slot j holds."""
        if self.n_q % self.tp:          # MHA pad: wrap
            return j % self.n_kv
        f = self.n_kv_phys // self.n_kv  # GQA dup
        return j // f


def init_attention(generator: torch.Generator, dims: AttnDims, dtype, *,
                   qkv_bias: bool = False) -> dict:
    """Physical weights built from logical initializations (TP-exact
    expansion), on the generator's device."""
    d, dh = dims.d_model, dims.d_head
    dev = generator.device
    s = float(1.0 / np.sqrt(d))
    wq_l = normal(generator, (d, dims.n_q, dh), dtype, s)
    wk_l = normal(generator, (d, dims.n_kv, dh), dtype, s)
    wv_l = normal(generator, (d, dims.n_kv, dh), dtype, s)
    wo_l = normal(generator, (dims.n_q, dh, d), dtype,
                  float(1.0 / np.sqrt(dims.n_q * dh)))

    # expand to physical
    nq_p, nkv_p = dims.n_q_phys, dims.n_kv_phys
    wq = torch.zeros((d, nq_p, dh), dtype=dtype, device=dev)
    wq[:, :dims.n_q] = wq_l
    wo = torch.zeros((nq_p, dh, d), dtype=dtype, device=dev)
    wo[:dims.n_q] = wo_l
    kv_map = torch.tensor([dims.kv_logical_index(j) for j in range(nkv_p)],
                          device=dev)
    wk = wk_l[:, kv_map]
    wv = wv_l[:, kv_map]
    p = {"wq": wq.reshape(d, nq_p * dh), "wk": wk.reshape(d, nkv_p * dh),
         "wv": wv.reshape(d, nkv_p * dh), "wo": wo.reshape(nq_p * dh, d)}
    if qkv_bias:
        bq_l = normal(generator, (dims.n_q, dh), dtype, 0.01)
        bk_l = normal(generator, (dims.n_kv, dh), dtype, 0.01)
        bv_l = normal(generator, (dims.n_kv, dh), dtype, 0.01)
        bq = torch.zeros((nq_p, dh), dtype=dtype, device=dev)
        bq[:dims.n_q] = bq_l
        p["bq"] = bq.reshape(nq_p * dh)
        p["bk"] = bk_l[kv_map].reshape(nkv_p * dh)
        p["bv"] = bv_l[kv_map].reshape(nkv_p * dh)
    return p


def _project_qkv(params, x, dims: AttnDims):
    """q (B,S,Hq,dh), k and v (B,S,G,dh), before RoPE."""
    b, s, _ = x.shape
    dh = dims.d_head
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, dims.n_q_phys, dh)
    k = k.reshape(b, s, dims.n_kv_phys, dh)
    v = v.reshape(b, s, dims.n_kv_phys, dh)
    return q, k, v


def _mask_bias(q_pos, k_pos, swa_window):
    """(Sq, Sk) additive float32 mask: causal (+ sliding window)."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if swa_window:
        ok &= k_pos[None, :] > q_pos[:, None] - swa_window
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, bias):
    """Grouped scaled-dot-product attention, fp32 softmax.

    q: (B, Sq, G, R, Dh), k/v: (B, Sk, G, Dh), bias: (Sq, Sk) additive.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k).float() * scale
    scores = scores + bias
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v)


def _largest_halving(block: int, s: int) -> int:
    """``block`` halved until it divides ``s`` (at least 1), as the reference
    picks the Pallas kernel's block sizes."""
    while s % block:
        block //= 2
    return max(block, 1)


def attention_train(params, x, dims: AttnDims, *, positions=None,
                    swa_window=None, rope_theta=10000.0, impl="dense",
                    chunk_q=1024, chunk_k=1024):
    """Causal self-attention over a full sequence (train / prefill).

    impl='dense'   — materializes (Sq, Sk) scores per head group (small seqs).
    impl='chunked' — flash-style online softmax over q chunks x kv chunks.
    impl='wedge'   — the same over the causal triangle of chunk pairs only.
    impl='pallas'  — the CUDA flash-attention kernel (the name is the
                     reference's, whose configs select its Pallas kernel so);
                     on CPU tensors its plain version.
    Returns (out (B,S,d), k, v) so prefill can build a cache for free.
    """
    b, s, _ = x.shape
    if impl not in ("dense", "chunked", "wedge", "pallas"):
        raise ValueError(impl)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, dims)
    core = functools.partial(_train_core, swa_window=swa_window,
                             rope_theta=rope_theta, impl=impl,
                             chunk_q=chunk_q, chunk_k=chunk_k)
    mesh = mesh_of(q)
    in_pl = out_pl = None
    if mesh is not None:
        mr = head_roles(q, 2, dims.n_q_phys, dims.n_kv_phys)
        qpl = layout(mr, batch=0, heads=2)
        in_pl = (qpl, qpl, qpl, layout(mr, batch=0))
        out_pl = (qpl, qpl, qpl)
    out, k, v = on_shards(core, mesh, (q, k, v, positions), in_pl, out_pl)
    out = out.reshape(b, s, dims.n_q_phys * dims.d_head)
    return out @ params["wo"], k, v


def _train_core(q, k, v, positions, *, swa_window, rope_theta, impl,
                chunk_q, chunk_k):
    """RoPE and attention of (local) q (B,S,Hq,dh), k/v (B,S,G,dh) ->
    (out (B,S,Hq,dh), k after RoPE, v)."""
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    b, s, hq, dh = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, hq // g, dh)

    if impl == "dense":
        pos = torch.arange(s, device=q.device)
        out = _sdpa(qg, k, v, _mask_bias(pos, pos, swa_window))
    elif impl == "chunked":
        out = _chunked_causal(qg, k, v, swa_window, chunk_q, chunk_k)
    elif impl == "wedge":
        out = _wedge_causal(qg, k, v, swa_window, chunk_q)
    else:
        from repro_torch.kernels import ops
        # (B, S, H, D) -> (B, H, S, D) views: the kernel reads the strides,
        # and its output keeps q's layout, so the transpose back is free
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, swa_window=swa_window,
            block_q=_largest_halving(chunk_q, s),
            block_k=_largest_halving(chunk_k, s), device=q.device)
        out = o.transpose(1, 2)
    return out.reshape(b, s, hq, dh), k, v


def _largest_divisor(chunk: int, s: int) -> int:
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _attend(qc, q_pos, k, v, ck: int, kv_chunks, swa_window):
    """Online softmax of one q chunk (b, cq, g, r, dh) over the kv chunks
    ``kv_chunks`` of length ``ck``, in that order -> (b, g, r, cq, dh)."""
    b, cq, g, r, dh = qc.shape
    scale = 1.0 / math.sqrt(dh)
    dev = qc.device
    m = torch.full((b, g, r, cq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, g, r, cq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, g, r, cq, dh), dtype=torch.float32, device=dev)
    for ki in kv_chunks:
        kc = k[:, ki * ck:(ki + 1) * ck]
        vc = v[:, ki * ck:(ki + 1) * ck]
        k_pos = ki * ck + torch.arange(ck, device=dev)
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qc, kc).float() * scale
        ok = k_pos[None, :] <= q_pos[:, None]
        if swa_window:
            ok &= k_pos[None, :] > q_pos[:, None] - swa_window
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(sc - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", pexp.to(qc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(qc.dtype)


def _chunked_causal(qg, k, v, swa_window, chunk_q, chunk_k):
    """Flash-style attention in plain torch: O(chunk_q x chunk_k) live scores.

    Visits every (q-chunk, kv-chunk) pair and masks, as the reference's
    baseline schedule does.
    """
    s = qg.shape[1]
    cq = _largest_divisor(chunk_q, s)
    ck = _largest_divisor(chunk_k, s)
    outs = [_attend(qg[:, qi * cq:(qi + 1) * cq],
                    qi * cq + torch.arange(cq, device=qg.device), k, v, ck,
                    range(s // ck), swa_window)
            for qi in range(s // cq)]
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)  # (b, s, g, r, dh)


def _wedge_causal(qg, k, v, swa_window, chunk):
    """Causal-FLOP-optimal chunked attention (the reference's "wedge").

    q chunk i visits kv chunks 0..i only, in order: the visits, and so the
    arithmetic, of the reference's schedule, which pairs chunk p with chunk
    nq-1-p only to give its ``lax.scan`` a constant trip count (nq+1).
    Executed score FLOPs are (nq+1)/(2·nq) of the all-pairs baseline.  An
    odd chunk count falls back to the all-pairs schedule, as the reference
    does.
    """
    s = qg.shape[1]
    cq = _largest_divisor(chunk, s)
    nq = s // cq
    if nq % 2:  # odd chunk counts: fall back to the all-pairs schedule
        return _chunked_causal(qg, k, v, swa_window, cq, cq)
    outs = [_attend(qg[:, qi * cq:(qi + 1) * cq],
                    qi * cq + torch.arange(cq, device=qg.device), k, v, cq,
                    range(qi + 1), swa_window)
            for qi in range(nq)]
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)  # (b, s, g, r, dh)


# ------------------------------------------------------------- decode -------

def attention_cache_shapes(batch: int, max_len: int, dims: AttnDims, dtype,
                           *, kv_quant: bool = False, swa_window=None
                           ) -> dict:
    """``init_attention_cache``'s leaves as ``LeafShape``s. SWA archs use a
    ring buffer of size window."""
    length = min(max_len, swa_window) if swa_window else max_len
    kv = (batch, length, dims.n_kv_phys, dims.d_head)
    if kv_quant:
        scale = kv[:-1] + (1,)
        cache = {"k_q": LeafShape(kv, torch.int8),
                 "v_q": LeafShape(kv, torch.int8),
                 "k_s": LeafShape(scale, torch.float32),
                 "v_s": LeafShape(scale, torch.float32)}
    else:
        cache = {"k": LeafShape(kv, dtype), "v": LeafShape(kv, dtype)}
    if swa_window:
        cache["slot_pos"] = LeafShape((length,), torch.int32)
    return cache


def init_attention_cache(batch: int, max_len: int, dims: AttnDims, dtype,
                         *, kv_quant: bool = False, swa_window=None,
                         device="cuda") -> dict:
    """Cache dict of tensors on ``device``: zeros, but a ring buffer's slot
    positions, -1."""
    return {k: torch.full(s.shape, -1 if k == "slot_pos" else 0,
                          dtype=s.dtype, device=device)
            for k, s in attention_cache_shapes(
                batch, max_len, dims, dtype, kv_quant=kv_quant,
                swa_window=swa_window).items()}


def _quantize_kv(x):
    s = x.float().abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def _cache_call(core, cache: dict, tensors: tuple, *, returns: bool):
    """``core(*tensors, cache)`` on each rank's (batch, head) shard, laid out
    as the cache is (whose tensors are written in place there), its output
    (if it ``returns`` one) laid out so too; ``tensors`` have the batch at
    dim 0 and the heads at dim 2."""
    names = tuple(cache)
    main = cache["k_q" if "k_q" in cache else "k"]
    mesh = mesh_of(main)
    in_pl = out_pl = None
    if mesh is not None:
        mr = head_roles(main, 2, main.shape[2])
        pl = layout(mr, batch=0, heads=2)
        in_pl = (pl,) * len(tensors) + tuple(cache[n].placements
                                             for n in names)
        out_pl = (pl,) if returns else None
    n = len(tensors)
    return on_shards(lambda *a: core(*a[:n], dict(zip(names, a[n:]))), mesh,
                     tensors + tuple(cache[k] for k in names), in_pl, out_pl)


def fill_attention_cache(cache: dict, k, v, *, swa_window=None) -> dict:
    """Write prefill k/v (B, S, g, dh) into a fresh cache (positions
    0..S-1), in place; returns the same dict.  A cache of DTensors is
    written on each rank's shard."""
    _cache_call(lambda k, v, c: _fill_core(c, k, v, swa_window), cache,
                (k, v), returns=False)
    return cache


def _fill_core(cache: dict, k, v, swa_window) -> None:
    s = k.shape[1]
    length = cache["k_q" if "k_q" in cache else "k"].shape[1]
    if swa_window and s > length:
        k, v = k[:, -length:], v[:, -length:]
        start = s - length
    else:
        start = 0
    n = k.shape[1]
    if "k_q" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k_q"][:, :n] = kq
        cache["v_q"][:, :n] = vq
        cache["k_s"][:, :n] = ks
        cache["v_s"][:, :n] = vs
    else:
        cache["k"][:, :n] = k
        cache["v"][:, :n] = v
    if "slot_pos" in cache:
        cache["slot_pos"][:n] = start + torch.arange(
            n, dtype=torch.int32, device=k.device)


def attention_decode(params, x, cache: dict, pos: int, dims: AttnDims, *,
                     swa_window=None, rope_theta=10000.0):
    """One-token decode. x: (B, 1, d); pos: the current position (an int).

    Writes the new k/v into ``cache`` in place; returns (out (B,1,d), cache).
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, dims)
    core = functools.partial(_decode_core, pos=int(pos),
                             swa_window=swa_window, rope_theta=rope_theta)
    out = _cache_call(core, cache, (q, k_new, v_new), returns=True)
    out = out.reshape(b, 1, dims.n_q_phys * dims.d_head)
    return out @ params["wo"], cache


def _decode_core(q, k_new, v_new, cache: dict, *, pos: int, swa_window,
                 rope_theta):
    """RoPE, the cache write and attention of one token on (local) q
    (B,1,Hq,dh), k/v (B,1,G,dh) -> out (B,1,Hq,dh)."""
    b, _, hq, dh = q.shape
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=q.device)
    q = apply_rope(q, positions, rope_theta)
    k_new = apply_rope(k_new, positions, rope_theta)
    g = k_new.shape[2]
    qg = q.reshape(b, 1, g, hq // g, dh)

    length = (cache["k"] if "k" in cache else cache["k_q"]).shape[1]
    slot = (pos % length) if swa_window else pos
    if "k_q" in cache:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache["k_q"][:, slot:slot + 1] = kq
        cache["v_q"][:, slot:slot + 1] = vq
        cache["k_s"][:, slot:slot + 1] = ks
        cache["v_s"][:, slot:slot + 1] = vs
        k_all = (cache["k_q"].float() * cache["k_s"]).to(q.dtype)
        v_all = (cache["v_q"].float() * cache["v_s"]).to(q.dtype)
    else:
        cache["k"][:, slot:slot + 1] = k_new
        cache["v"][:, slot:slot + 1] = v_new
        k_all, v_all = cache["k"], cache["v"]

    if swa_window:
        cache["slot_pos"][slot] = pos
        sp = cache["slot_pos"]
        valid = (sp >= 0) & (sp <= pos) & (sp > pos - swa_window)
    else:
        valid = torch.arange(length, device=q.device) <= pos

    scale = 1.0 / math.sqrt(dh)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_all).float() * scale
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v_all)
    return out.reshape(b, 1, hq, dh)


def attn_flops(dims: AttnDims, tokens: int, kv_len: int, *, causal=True
               ) -> float:
    """MODEL flops for attention (projections + scores + pv), logical heads."""
    d, hq, hkv, dh = dims.d_model, dims.n_q, dims.n_kv, dims.d_head
    proj = 2.0 * tokens * d * dh * (hq + 2 * hkv) + 2.0 * tokens * hq * dh * d
    eff_kv = kv_len / 2 if causal and kv_len == tokens else kv_len
    sdp = 2.0 * 2.0 * tokens * hq * dh * eff_kv
    return proj + sdp
