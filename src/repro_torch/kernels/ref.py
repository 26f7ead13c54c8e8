"""Plain PyTorch versions of the port's kernels.

They compute what ``src/repro/kernels/ref.py``'s ``flash_attention_ref``,
``ssd_scan_ref``, ``block_stats_ref`` and ``block_stats_batched_ref``
compute, on any device: the CPU path of the kernel wrappers, and what the
tests and ``chip_smoke.py`` hold the CUDA kernels against; never the card's
main path.  ``ssd_chunked_ref`` is the chunked SSD of
``src/repro/models/mamba2.py:_ssd_chunked`` without its D-skip term, the
plain version of the ``ssd_scan`` kernel; ``ssd_split_ref`` computes the
same function split as that kernel splits it (64-row chunks, C B^T once per
group, the head dim in slices), for the tests only.  ``ssd_chunked_bwd_ref``
is autograd of ``ssd_chunked_ref``, the plain version of the ``ssd_scan``
backward kernels, and ``ssd_split_bwd_ref`` the same gradients split as
those kernels split them (32-row chunks), for the tests only.  Counts and
mass are summed as int64 and cast to float32 once, so mass is the exact
sum rounded to float32; the reference sums mass in float32, which is
inexact past 2**24.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "ssd_scan_ref", "ssd_chunked_ref",
           "ssd_split_ref", "ssd_chunked_bwd_ref", "ssd_split_bwd_ref",
           "SSD_CHUNK", "SSD_P_SLICE", "SSD_BWD_CHUNK", "row_matches",
           "row_stats", "block_stats_ref", "block_stats_batched_ref"]

NEG_INF = -1e30
SSD_CHUNK = 64      # rows of a chunk in the CUDA SSD kernel
SSD_P_SLICE = 64    # head-dim columns of one CTA of the CUDA SSD kernel
SSD_BWD_CHUNK = 32  # rows of a chunk in the CUDA SSD backward kernels
SSD_REF_BLOCK = 1 << 27  # decay elements of a block of ssd_chunked_ref


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, swa_window=None,
                        q_start: int = 0) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, S, D) -> (B, Hq, Sq, D) in q's dtype;
    Sq = S unless ``q_start`` says otherwise.

    Materialises the (Sq, S) scores in float32, masks them with the finite
    -1e30 (causal; ``swa_window`` falsy means no window) and takes a float32
    softmax; kv head = q head // (Hq / Hkv).  With ``q_start``, q holds
    only the queries at positions ``q_start`` .. ``q_start + Sq - 1`` of the
    S keys (some rows of a long sequence's output, without its (S, S)
    scores).
    """
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) \
        * (1.0 / math.sqrt(d))
    q_pos = q_start + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if swa_window:
        ok &= k_pos[None, :] > q_pos[:, None] - swa_window
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor) -> torch.Tensor:
    """Naive O(S) recurrence. x: (BH,S,P), dt: (BH,S), b/c: (BH,S,N) ->
    y (BH,S,P) in x's dtype; the state is float32."""
    bh, s, p = x.shape
    n = b_mat.shape[-1]
    a = -torch.exp(a_log.float())                        # (BH,)
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    xf, dtf = x.float(), dt.float()
    bf, cf = b_mat.float(), c_mat.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                 # (BH,)
        h = h * decay[:, None, None] + torch.einsum(
            "b,bn,bp->bpn", dtf[:, t], bf[:, t], xf[:, t])
        ys.append(torch.einsum("bpn,bn->bp", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bh, 0, p))
    return y.to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                    chunk: int = 256) -> tuple:
    """Chunked SSD without the D-skip term.

    x (B,S,H,P), dt (B,S,H) (post-softplus), a_log (H,), b/c (B,S,G,N) with
    H = G*R -> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) float32).
    The chunk is the reference model's: ``min(chunk, S)``, decremented
    until it divides S.  Every product is pairwise: the largest intermediate
    is the (B,q,q,G,R) decay, never a (B,q,q,G,R,P) tensor.  Decays are exp
    of non-positive sums (A < 0), and exp is taken only on and below the
    diagonal.  The chunks are taken as many at a time as keep a block's
    decay within ``SSD_REF_BLOCK`` elements: each product of a block is one
    batched product, and only the carried state steps from chunk to chunk
    (one row of 524,272 positions is 2,114 chunks of 248, a loop that one
    chunk at a time spends on launching its ops).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    r = h // g
    q = max(min(chunk, s), 1)
    while s % q:
        q -= 1
    nc = s // q
    a = -torch.exp(a_log.float())                         # (H,) negative
    dtf = dt.float()
    dta = dtf * a                                         # (B,S,H)

    def cm(t, shape):   # chunk-major: (nc, B, q, ...)
        return t.reshape((bsz, nc, q) + shape).transpose(0, 1)

    xc_all = cm(x, (g, r, p))
    dtc_all = cm(dtf, (g, r))
    dtac_all = cm(dta, (g, r))
    bc_all = cm(b_mat, (g, n))
    cc_all = cm(c_mat, (g, n))
    below = torch.ones((q, q), dtype=torch.bool,
                       device=x.device).tril()[:, :, None, None]
    blk = max(1, SSD_REF_BLOCK // max(1, bsz * q * q * h))
    hprev = torch.zeros((bsz, g, r, p, n), dtype=torch.float32,
                        device=x.device)
    y = torch.empty((bsz, nc, q, g, r, p), dtype=x.dtype, device=x.device)
    for c0 in range(0, nc, blk):
        sl = slice(c0, c0 + blk)
        xc = xc_all[sl].float()                           # (k,B,q,g,r,p)
        dtc, dtac = dtc_all[sl], dtac_all[sl]             # (k,B,q,g,r)
        bc, cc = bc_all[sl].float(), cc_all[sl].float()   # (k,B,q,g,n)
        seg = torch.cumsum(dtac, dim=2)                   # (k,B,q,g,r)
        li = seg[:, :, :, None] - seg[:, :, None, :]      # (k,B,q,q,g,r)
        decay = torch.exp(li.masked_fill(~below, -torch.inf))
        scores = torch.einsum("kbign,kbjgn->kbijg", cc, bc)
        wgt = scores[..., None] * decay * dtc[:, :, None]
        y_intra = torch.einsum("kbijgr,kbjgrp->kbigrp", wgt, xc)
        tail = torch.exp(seg[:, :, -1:] - seg)            # (k,B,q,g,r)
        xw = xc * (tail * dtc)[..., None]                 # (k,B,q,g,r,p)
        state = torch.einsum("kbjgrp,kbjgn->kbgrpn", xw, bc)
        last = torch.exp(seg[:, :, -1])[..., None, None]  # (k,B,g,r,1,1)
        entering = []                                     # each chunk's
        for i in range(state.shape[0]):                   # carried state
            entering.append(hprev)
            hprev = hprev * last[i] + state[i]
        y_inter = torch.einsum("kbign,kbgrpn->kbigrp", cc,
                               torch.stack(entering)) \
            * torch.exp(seg)[..., None]
        y[:, sl] = (y_intra + y_inter).to(x.dtype).transpose(0, 1)
    return y.reshape(bsz, s, h, p), hprev.reshape(bsz, h, p, n)


def ssd_split_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                  chunk: int = SSD_CHUNK, p_slice: int = SSD_P_SLICE
                  ) -> tuple:
    """The SSD of ``ssd_chunked_ref`` split as the CUDA kernel splits it.

    Same arguments and result.  S is padded to whole chunks of ``chunk``
    rows with dt = 0 (a padded row adds nothing and decays nothing) and
    zeros, and the padded rows are dropped from y.  First C B^T, masked to
    its lower triangle, once per (batch, group, chunk); then for each head
    and each slice of ``min(P, p_slice)`` head-dim columns, which carries
    its own rows of the state: M = (C B^T) * exp(seg_i - seg_j) dt_j on and
    below the diagonal, y = exp(seg) (C h^T) + M x, and h = exp(seg_last) h
    + (w x)^T B with w_j = exp(seg_last - seg_j) dt_j.
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    r = h // g
    ps = min(p, p_slice)
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunked(t):   # (B, S, ...) float32, zero-padded -> (B, nc, L, ...)
        t = t.float()
        t = torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape((bsz, nc, chunk) + t.shape[2:])

    xf = chunked(x).reshape(bsz, nc, chunk, g, r, p)
    dtf = chunked(dt).reshape(bsz, nc, chunk, g, r)
    bf, cf = chunked(b_mat), chunked(c_mat)               # (B,nc,L,G,N)
    a = -torch.exp(a_log.float()).reshape(g, r)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    cb = torch.einsum("bcign,bcjgn->bcgij", cf, bf).masked_fill(~tri, 0.0)
    state = torch.zeros((bsz, g, r, p, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(nc):
        dtc = dtf[:, c].permute(0, 2, 3, 1)               # (B,G,R,L)
        seg = torch.cumsum(dtc * a[None, :, :, None], dim=-1)
        diff = seg[..., :, None] - seg[..., None, :]      # (B,G,R,L,L)
        decay = torch.exp(diff.masked_fill(~tri, -torch.inf))
        m = cb[:, c, :, None] * decay * dtc[..., None, :]
        es = torch.exp(seg)
        w = torch.exp(seg[..., -1:] - seg) * dtc
        last = torch.exp(seg[..., -1])[..., None, None]
        xc = xf[:, c].permute(0, 2, 3, 1, 4)             # (B,G,R,L,P)
        bc, cc = bf[:, c], cf[:, c]                       # (B,L,G,N)
        yc = torch.empty_like(xc)
        for p0 in range(0, p, ps):
            cols = slice(p0, p0 + ps)
            hprev = state[..., cols, :]                   # (B,G,R,ps,N)
            yc[..., cols] = es[..., None] * torch.einsum(
                "bign,bgrpn->bgrip", cc, hprev) + torch.einsum(
                "bgrij,bgrjp->bgrip", m, xc[..., cols])
            state[..., cols, :] = last * hprev + torch.einsum(
                "bgrjp,bjgn->bgrpn", w[..., None] * xc[..., cols], bc)
        ys.append(yc.reshape(bsz, h, chunk, p).transpose(1, 2))
    y = torch.cat(ys, dim=1)[:, :s] if ys else x.new_zeros(x.shape).float()
    return y.to(x.dtype), state.reshape(bsz, h, p, n)


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b_mat: torch.Tensor,
                        c_mat: torch.Tensor, dy, dstate=None, *,
                        chunk: int = 256) -> tuple:
    """Gradients of ``ssd_chunked_ref``: (dx, ddt, da_log, dB, dC), each of
    its input's shape and type, for the cotangents ``dy`` of y and
    ``dstate`` of the final state (None for either means zero).  It is
    ``torch.autograd.grad`` of ``ssd_chunked_ref`` recomputed under
    ``enable_grad``: the CPU route of the ``ssd_scan`` autograd Function,
    and the card's yardstick for its backward kernel."""
    ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b_mat,
                                                 c_mat)]
    with torch.enable_grad():
        y, state = ssd_chunked_ref(*ins, chunk=chunk)
        outs = [(o, g) for o, g in ((y, dy), (state, dstate))
                if g is not None and o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in outs],
                                    ins, [g for _, g in outs],
                                    allow_unused=True) if outs \
            else [None] * len(ins)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ins))


def ssd_split_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b_mat: torch.Tensor, c_mat: torch.Tensor, dy,
                      dstate=None, *, chunk: int = SSD_BWD_CHUNK) -> tuple:
    """The gradients of ``ssd_chunked_bwd_ref`` computed as the CUDA
    backward (``csrc/ssd_scan_bwd.cu``) splits them, for the tests only.

    Same arguments and result.  S is padded to whole chunks of ``chunk``
    rows with dt = 0 and zeros.  Per (batch, head), a is dt A with
    A = -exp(a_log), seg the inclusive cumsum of a in a chunk, u_j = dt_j
    x_j, E_ij = exp(seg_i - seg_j) on and below the diagonal:

    1. states: h_{c-1}, the state entering chunk c, forward over the
       chunks; dh_c, the cotangent of the state leaving it, backward from
       ``dstate``: dh_{c-1} = exp(seg_last) dh_c + sum_i exp(seg_i) dy_i
       (x) C_i;
    2. per chunk: K = (C B^T) E and W = E (dy_i . u_j) give
       du_j = sum_i K_ij dy_i + exp(seg_last - seg_j) dh_c B_j,
       dC_i = sum_j W_ij B_j + exp(seg_i) h_{c-1}^T dy_i and
       dB_j = sum_i W_ij C_i + exp(seg_last - seg_j) dh_c^T u_j; dx =
       dt du, and dt's direct share is x . du; d seg takes every
       exponent's cotangent, d a is its reverse cumsum in the chunk, and
       ddt += A d a, da_log = A sum dt d a;
    3. dB and dC summed over the heads of their group (the kernels sum
       each cluster's heads in shared memory, then the clusters).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    r = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunked(t):   # (B, S, ...) float32, zero-padded -> (B, nc, L, ...)
        t = t.float()
        t = torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape((bsz, nc, chunk) + t.shape[2:])

    head_group = torch.arange(h, device=x.device) // r
    xf, dyf = chunked(x), chunked(dy)                     # (B,nc,L,H,P)
    dtf = chunked(dt)                                     # (B,nc,L,H)
    bf = chunked(b_mat)[:, :, :, head_group]              # (B,nc,L,H,N)
    cf = chunked(c_mat)[:, :, :, head_group]
    a = -torch.exp(a_log.float())                         # (H,)
    seg = torch.cumsum(dtf * a, dim=2)                    # (B,nc,L,H)
    last = seg[:, :, -1:]                                 # (B,nc,1,H)
    es, tail = torch.exp(seg), torch.exp(last - seg)

    # 1. the states entering and the cotangents leaving each chunk
    hs, dhs = [], [None] * nc
    state = xf.new_zeros((bsz, h, p, n))
    for c in range(nc):
        hs.append(state)
        state = torch.exp(last[:, c, 0])[..., None, None] * state \
            + torch.einsum("blh,blhp,blhn->bhpn", tail[:, c] * dtf[:, c],
                           xf[:, c], bf[:, c])
    dh = xf.new_zeros((bsz, h, p, n)) if dstate is None else dstate.float()
    for c in reversed(range(nc)):
        dhs[c] = dh
        dh = torch.exp(last[:, c, 0])[..., None, None] * dh \
            + torch.einsum("blh,blhp,blhn->bhpn", es[:, c], dyf[:, c],
                           cf[:, c])
    hprev, dhc = torch.stack(hs, 1), torch.stack(dhs, 1)  # (B,nc,H,P,N)

    # 2. every chunk's gradients
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    segt = seg.transpose(2, 3)                            # (B,nc,H,L)
    e = torch.exp((segt[..., :, None] - segt[..., None, :])
                  .masked_fill(~tri, -torch.inf))         # (B,nc,H,L,L)
    cb = torch.einsum("bcihn,bcjhn->bchij", cf, bf)
    dyu = torch.einsum("bcihp,bcjhp->bchij", dyf, xf) \
        * dtf.transpose(2, 3)[..., None, :]
    k_mat, w_mat = cb * e, e * dyu
    gmat = cb * w_mat
    dseg = (gmat.sum(-1) - gmat.sum(-2)).transpose(2, 3)  # (B,nc,L,H)
    du_inter = tail[..., None] * torch.einsum("bcjhn,bchpn->bcjhp", bf, dhc)
    s_j = dtf * (xf * du_inter).sum(-1)                   # (B,nc,L,H)
    du = du_inter + torch.einsum("bchij,bcihp->bcjhp", k_mat, dyf)
    dx = dtf[..., None] * du
    ddt = (xf * du).sum(-1)
    dc_h = es[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyf, hprev)
    dseg = dseg + (cf * dc_h).sum(-1) - s_j
    dc_h = dc_h + torch.einsum("bchij,bcjhn->bcihn", w_mat, bf)
    db_h = (tail * dtf)[..., None] * torch.einsum(
        "bcjhp,bchpn->bcjhn", xf, dhc) \
        + torch.einsum("bchij,bcihn->bcjhn", w_mat, cf)
    at_last = s_j.sum(2) + torch.exp(last[:, :, 0]) * (dhc * hprev).sum(
        (-1, -2))                                         # (B,nc,H)
    dseg = torch.cat([dseg[:, :, :-1], dseg[:, :, -1:] + at_last[:, :, None]],
                     dim=2)
    d_a = torch.flip(torch.cumsum(torch.flip(dseg, [2]), 2), [2])
    ddt = ddt + a * d_a
    da_log = a * (dtf * d_a).sum((0, 1, 2))

    # 3. dB and dC over the heads of each group
    def unpad(t):
        return t.reshape((bsz, nc * chunk) + t.shape[3:])[:, :s]

    db = unpad(db_h.reshape(bsz, nc, chunk, g, r, n).sum(4))
    dc = unpad(dc_h.reshape(bsz, nc, chunk, g, r, n).sum(4))
    return (unpad(dx).to(x.dtype), unpad(ddt).to(dt.dtype),
            da_log.to(a_log.dtype), db.to(b_mat.dtype), dc.to(c_mat.dtype))


def row_matches(tokens: torch.Tensor, pattern) -> torch.Tensor:
    """Contiguous occurrences of ``pattern`` in each row of ``tokens``
    (..., L) -> (...) int64; a pattern longer than the row gives 0."""
    p = len(pattern)
    length = tokens.shape[-1]
    if length < p:
        return torch.zeros(tokens.shape[:-1], dtype=torch.int64,
                           device=tokens.device)
    hits = tokens[..., :length - p + 1] == int(pattern[0])
    for j in range(1, p):
        hits &= tokens[..., j:length - p + 1 + j] == int(pattern[j])
    return hits.sum(-1)


def row_stats(tokens: torch.Tensor, pattern) -> tuple:
    """Per-row ``(nonpad, matches, mass)`` of ``tokens`` (..., L), each an
    int64 tensor of shape (...)."""
    nonpad = (tokens != 0).sum(-1)
    mass = tokens.sum(-1, dtype=torch.int64)
    return nonpad, row_matches(tokens, pattern), mass


def block_stats_ref(tokens: torch.Tensor, pattern=(17, 23, 5)) -> torch.Tensor:
    """(N, L) int tokens -> (3,) float32 ``[nonpad, matches, mass]``."""
    return torch.stack([s.sum() for s in row_stats(tokens, pattern)]).to(
        torch.float32)


def block_stats_batched_ref(tokens: torch.Tensor, lengths=None,
                            pattern=(17, 23, 5)) -> torch.Tensor:
    """(nb, R, L) tokens [+ (nb,) valid-row counts] -> (nb, 3) float32.

    Rows at or past ``lengths[b]`` are left out: a length above R means all
    rows, 0 or a negative length none, ``None`` all rows of every block.
    """
    stats = torch.stack(row_stats(tokens, pattern), dim=-1)   # (nb, R, 3)
    if lengths is not None:
        n_blocks, rows, _ = tokens.shape
        lengths = torch.as_tensor(lengths, device=tokens.device).reshape(
            n_blocks).to(torch.int64)
        valid = torch.arange(rows, device=tokens.device)[None, :] \
            < lengths[:, None]
        stats = stats * valid[..., None]
    return stats.sum(dim=1).to(torch.float32)
