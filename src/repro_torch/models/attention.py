"""GQA attention: TP-aware head layout, RoPE, SWA, chunked (flash-style)
softmax, the CUDA flash-attention kernel, and decode with (optionally int8)
KV caches.

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
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.common import apply_rope, normal

NEG_INF = -1e30

__all__ = ["AttnDims", "init_attention", "attention_train",
           "attention_decode", "init_attention_cache", "fill_attention_cache",
           "attn_flops"]


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


def _project_qkv(params, x, dims: AttnDims, positions, rope_theta):
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
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
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
    impl='pallas'  — the CUDA flash-attention kernel (the name is the
                     reference's, whose configs select its Pallas kernel so);
                     on CPU tensors its plain version.
    Returns (out (B,S,d), k, v) so prefill can build a cache for free.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, dims, positions, rope_theta)
    g, r = dims.n_kv_phys, dims.rep_phys
    qg = q.reshape(b, s, g, r, dims.d_head)

    if impl == "dense":
        pos = torch.arange(s, device=x.device)
        out = _sdpa(qg, k, v, _mask_bias(pos, pos, swa_window))
    elif impl == "chunked":
        out = _chunked_causal(qg, k, v, swa_window, chunk_q, chunk_k)
    elif impl == "wedge":
        raise NotImplementedError(
            "impl='wedge' is not ported yet (ROADMAP Queue 1 item 11)")
    elif impl == "pallas":
        from repro_torch.kernels import ops
        # (B, S, H, D) -> (B, H, S, D) views: the kernel reads the strides,
        # and its output keeps q's layout, so the transpose back is free
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, swa_window=swa_window,
            block_q=_largest_halving(chunk_q, s),
            block_k=_largest_halving(chunk_k, s), device=x.device)
        out = o.transpose(1, 2).reshape(b, s, g, r, dims.d_head)
    else:
        raise ValueError(impl)
    out = out.reshape(b, s, dims.n_q_phys * dims.d_head)
    return out @ params["wo"], k, v


def _largest_divisor(chunk: int, s: int) -> int:
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _chunked_causal(qg, k, v, swa_window, chunk_q, chunk_k):
    """Flash-style attention in plain torch: O(chunk_q x chunk_k) live scores.

    Visits every (q-chunk, kv-chunk) pair and masks, as the reference's
    baseline schedule does.
    """
    b, s, g, r, dh = qg.shape
    cq = _largest_divisor(chunk_q, s)
    ck = _largest_divisor(chunk_k, s)
    scale = 1.0 / math.sqrt(dh)
    dev = qg.device
    outs = []
    for qi in range(s // cq):
        qc = qg[:, qi * cq:(qi + 1) * cq]
        q_pos = qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, g, r, cq), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, g, r, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, g, r, cq, dh), dtype=torch.float32, device=dev)
        for ki in range(s // ck):
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
        outs.append(out.to(qg.dtype))                    # (b, g, r, cq, dh)
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)  # (b, s, g, r, dh)


# ------------------------------------------------------------- decode -------

def init_attention_cache(batch: int, max_len: int, dims: AttnDims, dtype,
                         *, kv_quant: bool = False, swa_window=None,
                         device="cuda") -> dict:
    """Cache dict of tensors on ``device``. SWA archs use a ring buffer of
    size window."""
    length = min(max_len, swa_window) if swa_window else max_len
    g, dh = dims.n_kv_phys, dims.d_head
    z = dict(device=device)
    if kv_quant:
        cache = {"k_q": torch.zeros((batch, length, g, dh), dtype=torch.int8,
                                    **z),
                 "v_q": torch.zeros((batch, length, g, dh), dtype=torch.int8,
                                    **z),
                 "k_s": torch.zeros((batch, length, g, 1),
                                    dtype=torch.float32, **z),
                 "v_s": torch.zeros((batch, length, g, 1),
                                    dtype=torch.float32, **z)}
    else:
        cache = {"k": torch.zeros((batch, length, g, dh), dtype=dtype, **z),
                 "v": torch.zeros((batch, length, g, dh), dtype=dtype, **z)}
    if swa_window:
        cache["slot_pos"] = torch.full((length,), -1, dtype=torch.int32, **z)
    return cache


def _quantize_kv(x):
    s = x.float().abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def fill_attention_cache(cache: dict, k, v, *, swa_window=None) -> dict:
    """Write prefill k/v (B, S, g, dh) into a fresh cache (positions
    0..S-1), in place; returns the same dict."""
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
    return cache


def attention_decode(params, x, cache: dict, pos: int, dims: AttnDims, *,
                     swa_window=None, rope_theta=10000.0):
    """One-token decode. x: (B, 1, d); pos: the current position (an int).

    Writes the new k/v into ``cache`` in place; returns (out (B,1,d), cache).
    """
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, dims, positions, rope_theta)
    g, r, dh = dims.n_kv_phys, dims.rep_phys, dims.d_head
    qg = q.reshape(b, 1, g, r, dh)

    length = (cache["k"] if "k" in cache else cache["k_q"]).shape[1]
    slot = (pos % length) if swa_window else pos
    if "k_q" in cache:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache["k_q"][:, slot:slot + 1] = kq
        cache["v_q"][:, slot:slot + 1] = vq
        cache["k_s"][:, slot:slot + 1] = ks
        cache["v_s"][:, slot:slot + 1] = vs
        k_all = (cache["k_q"].float() * cache["k_s"]).to(x.dtype)
        v_all = (cache["v_q"].float() * cache["v_s"]).to(x.dtype)
    else:
        cache["k"][:, slot:slot + 1] = k_new
        cache["v"][:, slot:slot + 1] = v_new
        k_all, v_all = cache["k"], cache["v"]

    if swa_window:
        cache["slot_pos"][slot] = pos
        sp = cache["slot_pos"]
        valid = (sp >= 0) & (sp <= pos) & (sp > pos - swa_window)
    else:
        valid = torch.arange(length, device=x.device) <= pos

    scale = 1.0 / math.sqrt(dh)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_all).float() * scale
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(x.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v_all)
    out = out.reshape(b, 1, dims.n_q_phys * dh)
    return out @ params["wo"], cache


def attn_flops(dims: AttnDims, tokens: int, kv_len: int, *, causal=True
               ) -> float:
    """MODEL flops for attention (projections + scores + pv), logical heads."""
    d, hq, hkv, dh = dims.d_model, dims.n_q, dims.n_kv, dims.d_head
    proj = 2.0 * tokens * d * dh * (hq + 2 * hkv) + 2.0 * tokens * hq * dh * d
    eff_kv = kv_len / 2 if causal and kv_len == tokens else kv_len
    sdp = 2.0 * 2.0 * tokens * hq * dh * eff_kv
    return proj + sdp
