"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block.

The port of ``src/repro/models/mamba2.py``.  Chunked SSD: within a chunk the
recurrence is the quadratic masked form, across chunks a small carried state
(B, H, P, N) propagates.  ``_ssd_chunked`` runs it through
``repro_torch.kernels.ssd_scan.ssd_scan_cuda``: the hand-written CUDA kernel
on a CUDA tensor (which also writes the final state it carries), the plain
chunked version on a CPU tensor, chunked there as the reference chunks.  The
D-skip term is added outside, in the reference's order.

Projections are separate parameters (wz/wx/wb/wc/wdt), as in the reference.
Decode is the O(1) recurrence h = exp(dt·A)·h + dt·B⊗x ; y = C·h + D·x,
in plain torch (the reference has no kernel there); it updates the cache
in place, as the port's attention caches are updated.

On DTensors (``parallel.param_specs``: the head-aligned z/x/dt projections,
conv-x, ``a_log``, ``dt_bias``, ``d_skip`` and ``norm_scale`` over 'model',
the B/C projections replicated) the projections, convolutions and the gated
norm (whose mean crosses the sharded heads) are DTensor ops, and the SSD
scan, and decode's recurrence, run on each rank's (batch, head) shard under
``local_map``: a head's scan reads only its own x, dt and A and its group's
B/C, so the ``ssd_scan`` kernel runs on each rank's heads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models.common import LeafShape, normal, rms_norm
from repro_torch.parallel.shards import head_roles, layout, mesh_of, on_shards

__all__ = ["SSMConfig", "init_mamba", "mamba_train", "mamba_prefill",
           "mamba_decode", "mamba_cache_shapes", "init_mamba_cache",
           "mamba_flops"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def d_bc(self) -> int:
        return 2 * self.n_groups * self.d_state


def init_mamba(generator: torch.Generator, cfg: SSMConfig, dtype) -> dict:
    """Random weights from ``generator`` on its device; ``a_log``,
    ``dt_bias``, ``d_skip`` and the zero/one leaves take the reference's
    values (``dt_bias`` from NumPy's ``default_rng(0)``, as there)."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    gn = cfg.n_groups * cfg.d_state
    dev = generator.device
    s = float(1.0 / np.sqrt(d))
    dt_init = np.exp(np.random.default_rng(0).uniform(
        np.log(1e-3), np.log(1e-1), h))
    return {
        "wz": normal(generator, (d, di), dtype, s),
        "wx": normal(generator, (d, di), dtype, s),
        "wb": normal(generator, (d, gn), dtype, s),
        "wc": normal(generator, (d, gn), dtype, s),
        "wdt": normal(generator, (d, h), dtype, s),
        "conv_wx": normal(generator, (cfg.d_conv, di), dtype, 0.2),
        "conv_bx": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_wbc": normal(generator, (cfg.d_conv, 2 * gn), dtype, 0.2),
        "conv_bbc": torch.zeros((2 * gn,), dtype=dtype, device=dev),
        "a_log": torch.from_numpy(np.log(np.linspace(
            1.0, 16.0, h, dtype=np.float32))).to(dev),
        "dt_bias": torch.from_numpy(np.log(np.expm1(dt_init)).astype(
            np.float32)).to(dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal(generator, (di, d), dtype,
                           float(1.0 / math.sqrt(di))),
    }


def _causal_conv_train(xs, w, b):
    """Depthwise causal conv over (B, S, C): k taps, left-padded.  On
    DTensors it runs on each rank's (batch, channel) shard: a channel's
    conv reads only its own channel."""
    mesh = mesh_of(xs)
    in_pl = out_pl = None
    if mesh is not None:
        mr = head_roles(xs, 2, xs.shape[2])
        xpl = layout(mr, batch=0, heads=2)
        in_pl = (xpl, layout(mr, heads=1), layout(mr, heads=0))
        out_pl = (xpl,)
    return on_shards(_conv_core, mesh, (xs, w, b), in_pl, out_pl)


def _conv_core(xs, w, b):
    k = w.shape[0]
    pad = F.pad(xs, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xs.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, cfg: SSMConfig):
    """Chunked SSD through the ``ssd_scan`` kernel, then the D-skip term.

    x: (B,S,H,P)  dt: (B,S,H) float32 (post-softplus)  b_mat/c_mat:
    (B,S,G,N), H = G·R, views read as they are (never repeated per head).
    Returns y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) float32.
    On DTensors the scan runs on each rank's (batch, head) shard.
    """
    mesh = mesh_of(x)
    in_pl = out_pl = None
    if mesh is not None:
        g = b_mat.shape[2]
        mr = head_roles(x, 2, x.shape[2], g if g > 1 else None)
        xpl = layout(mr, batch=0, heads=2)
        bpl = layout(mr, batch=0, heads=2 if g > 1 else None)
        hpl = layout(mr, heads=0)
        in_pl = (xpl, xpl, hpl, bpl, bpl, hpl)
        out_pl = (xpl, layout(mr, batch=0, heads=1))
    return on_shards(lambda *a: _ssd_core(*a, chunk=cfg.chunk), mesh,
                     (x, dt, a_log, b_mat, c_mat, d_skip), in_pl, out_pl)


def _ssd_core(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int):
    y, hlast = ssd_scan_cuda(x, dt, a_log, b_mat, c_mat, chunk=chunk,
                             final_state=True)
    y = y.to(x.dtype) + x * d_skip[None, None, :, None].to(x.dtype)
    return y.to(x.dtype), hlast


def _project(params, u, cfg: SSMConfig):
    """u: (B,S,d) -> z (B,S,di), x_raw (B,S,di), bc_raw (B,S,2GN),
    dt (B,S,H)."""
    z = u @ params["wz"]
    x_raw = u @ params["wx"]
    bc_raw = torch.cat([u @ params["wb"], u @ params["wc"]], dim=-1)
    dt = u @ params["wdt"]
    return z, x_raw, bc_raw, dt


def _run_ssd(params, z, x_conv, bc_conv, dt, cfg: SSMConfig):
    bsz, s = z.shape[0], z.shape[1]
    h, p, g, n = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    x = x_conv.reshape(bsz, s, h, p)
    b_mat = bc_conv[..., :g * n].reshape(bsz, s, g, n)
    c_mat = bc_conv[..., g * n:].reshape(bsz, s, g, n)
    dtp = F.softplus(dt.float() + params["dt_bias"])
    y, hlast = _ssd_chunked(x, dtp, params["a_log"], b_mat, c_mat,
                            params["d_skip"], cfg)
    y = y.reshape(bsz, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm_scale"])
    return y @ params["out_proj"], hlast


def mamba_train(params, u, cfg: SSMConfig):
    """Full-sequence SSD. u: (B,S,d) -> (y: (B,S,d), final_state)."""
    z, x_raw, bc_raw, dt = _project(params, u, cfg)
    x_conv = _causal_conv_train(x_raw, params["conv_wx"], params["conv_bx"])
    bc_conv = _causal_conv_train(bc_raw, params["conv_wbc"],
                                 params["conv_bbc"])
    return _run_ssd(params, z, x_conv, bc_conv, dt, cfg)


def mamba_prefill(params, u, cfg: SSMConfig):
    """Full-sequence SSD returning a decode-ready cache.

    Conv caches hold the last (d_conv-1) RAW (pre-conv, pre-activation)
    values — matching mamba_decode's rolling-window semantics.
    """
    bsz, s, _ = u.shape
    k = cfg.d_conv - 1
    z, x_raw, bc_raw, dt = _project(params, u, cfg)

    def tail(t, width):
        if s >= k:
            return t[:, s - k:, :]
        return torch.cat([t.new_zeros((bsz, k - s, width)), t], dim=1)

    cache_x = tail(x_raw, cfg.d_inner)
    cache_bc = tail(bc_raw, cfg.d_bc)
    x_conv = _causal_conv_train(x_raw, params["conv_wx"], params["conv_bx"])
    bc_conv = _causal_conv_train(bc_raw, params["conv_wbc"],
                                 params["conv_bbc"])
    out, hlast = _run_ssd(params, z, x_conv, bc_conv, dt, cfg)
    return out, {"conv_x": cache_x, "conv_bc": cache_bc, "ssm": hlast}


def mamba_cache_shapes(batch: int, cfg: SSMConfig, dtype=torch.float32
                       ) -> dict:
    """``init_mamba_cache``'s leaves as ``LeafShape``s."""
    return {
        "conv_x": LeafShape((batch, cfg.d_conv - 1, cfg.d_inner), dtype),
        "conv_bc": LeafShape((batch, cfg.d_conv - 1, cfg.d_bc), dtype),
        "ssm": LeafShape((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                         torch.float32),
    }


def init_mamba_cache(batch: int, cfg: SSMConfig, dtype=torch.float32,
                     device="cuda") -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in mamba_cache_shapes(batch, cfg, dtype).items()}


def mamba_decode(params, u, cache: dict, cfg: SSMConfig):
    """One-token step. u: (B,1,d) -> (y: (B,1,d), cache), the cache's
    tensors updated in place."""
    z, x_raw, bc_raw, dt = _project(params, u, cfg)
    z, x_raw, bc_raw, dt = z[:, 0], x_raw[:, 0], bc_raw[:, 0], dt[:, 0]
    names = ("conv_wx", "conv_bx", "conv_wbc", "conv_bbc", "dt_bias",
             "a_log", "d_skip")
    keys = tuple(cache)
    args = (x_raw, bc_raw, dt) + tuple(params[k] for k in names) \
        + tuple(cache[k] for k in keys)
    mesh = mesh_of(cache["ssm"])
    in_pl = out_pl = None
    if mesh is not None:
        mr = head_roles(cache["ssm"], 1, cfg.n_heads,
                        cfg.n_groups if cfg.n_groups > 1 else None)
        if "heads" in mr and cfg.n_groups > 1:
            raise ValueError("decode shards Mamba heads only with one B/C "
                             f"group, not {cfg.n_groups}")
        hpl, rpl = layout(mr, heads=0), layout(mr)
        in_pl = (layout(mr, batch=0, heads=1), layout(mr, batch=0),
                 layout(mr, batch=0, heads=1), layout(mr, heads=1), hpl,
                 rpl, rpl, hpl, hpl, hpl) + tuple(cache[k].placements
                                                  for k in keys)
        out_pl = (layout(mr, batch=0, heads=1),)

    def core(x_raw, bc_raw, dt, *rest):
        p = dict(zip(names, rest[:len(names)]))
        return _decode_core(p, x_raw, bc_raw, dt,
                            dict(zip(keys, rest[len(names):])), cfg)

    y = on_shards(core, mesh, args, in_pl, out_pl)
    y = rms_norm(y.to(u.dtype) * F.silu(z), params["norm_scale"])
    return (y @ params["out_proj"])[:, None, :], cache


def _decode_core(params, x_raw, bc_raw, dt, cache: dict, cfg: SSMConfig):
    """The conv windows, the recurrence and the D-skip of one token on
    (local) x_raw (B,di), bc_raw (B,2GN), dt (B,H) -> y (B,di) float32;
    writes the cache in place."""
    bsz, h = dt.shape
    p, g, n = cfg.head_dim, cfg.n_groups, cfg.d_state
    win_x = torch.cat([cache["conv_x"], x_raw[:, None, :]], dim=1)
    win_bc = torch.cat([cache["conv_bc"], bc_raw[:, None, :]], dim=1)
    x_c = F.silu(torch.einsum("bkc,kc->bc", win_x, params["conv_wx"])
                 + params["conv_bx"])
    bc_c = F.silu(torch.einsum("bkc,kc->bc", win_bc, params["conv_wbc"])
                  + params["conv_bbc"])

    x = x_c.reshape(bsz, h, p)
    b_vec = bc_c[:, :g * n].reshape(bsz, g, n).repeat_interleave(h // g, 1)
    c_vec = bc_c[:, g * n:].reshape(bsz, g, n).repeat_interleave(h // g, 1)
    dtp = F.softplus(dt.float() + params["dt_bias"])                # (B,H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dtp * a)                                      # (B,H)

    xf = x.float()
    hnew = (cache["ssm"] * decay[:, :, None, None]
            + (dtp[:, :, None] * xf)[..., None]
            * b_vec.float()[:, :, None, :])                         # (B,H,P,N)
    y = torch.einsum("bhpn,bhn->bhp", hnew, c_vec.float())
    y = y + xf * params["d_skip"][None, :, None]
    cache["conv_x"].copy_(win_x[:, 1:])
    cache["conv_bc"].copy_(win_bc[:, 1:])
    cache["ssm"].copy_(hnew)
    return y.reshape(bsz, h * p)


def mamba_flops(cfg: SSMConfig, tokens: int) -> float:
    d, di, n, h, p = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    proj = 2.0 * tokens * d * (2 * di + cfg.d_bc + h) + 2.0 * tokens * di * d
    conv = 2.0 * tokens * cfg.d_conv * (di + cfg.d_bc)
    q = cfg.chunk
    ssd = 2.0 * tokens * h * (q * n + q * p + 2 * p * n)
    return proj + conv + ssd
