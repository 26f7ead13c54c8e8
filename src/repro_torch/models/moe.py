"""Mixture-of-Experts FFN — capacity-based scatter dispatch.

The port of ``src/repro/models/moe.py``.  Dispatch computes what the
reference computes, slot for slot: float32 router logits, softmax, top-k,
gates renormalised; each token's k slots ranked within their expert by an
exclusive cumsum of the one-hot over the token-major (token, k) order;
slots ranked below the capacity are scattered into an expert buffer and the
rest dropped; the expert MLPs run as batched products over that buffer; the
combine gathers each kept slot back, weights it by its gate and sums over
k.  Shared experts (Qwen2-MoE style) are a dense FFN added unconditionally.

Every group's buffer sits in one tensor of ``E·G·cap + 1`` rows of ``d``,
expert-major and viewed as ``(E, G·cap, d)``, so the expert products are one
``bmm`` over the ``(E, d, ff)`` weights (a ``(G, E, cap, d)`` buffer would
make ``matmul`` broadcast, and copy, the weights G times); the spare last row
takes every dropped slot, as the reference's ``mode="drop"`` scatter
discards index ``cap``.  No step reads a value back to the host, so a layer
on the card never waits for it.

On DTensors the groups lie over ``group_axis``; without one they keep the
layout the batch gave them (dim 0 sharded over a data axis, wherever the
groups split evenly there), as the reference's vmap over groups keeps it:
each rank routes, dispatches and combines its own groups under
``local_map``, so ranking and capacity never cross a group, and its buffer
rows are its groups' slots.  With ``expert_axis`` the buffer is
redistributed from its groups to its experts (an all-to-all) before the
expert products, which run on each rank's experts against the ``(E, d,
ff)`` weights laid out by ``param_specs`` (E over ``expert_axis``), and back
before the combine.  Collectives are device work: the sharded layer does
not synchronise with the host either.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import (apply_mlp, init_mlp, init_scale,
                                      normal)
from repro_torch.parallel.shards import (gather_fsdp, layout, mesh_of,
                                        on_shards, roles)

__all__ = ["MoEConfig", "init_moe", "apply_moe", "moe_flops"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # number of always-on shared experts
    d_ff_shared: int = 0        # total shared hidden size (n_shared * d_ff_expert)
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"
    router_aux_weight: float = 0.01
    # dispatch groups: ranking/scatter happen independently per group so nothing
    # (cumsum, scatter) ever crosses the data-sharded token dim.  Set to the DP
    # shard count in distributed runs; 1 on a single device.
    dispatch_groups: int = 1
    group_axis: str | None = None   # mesh axis to shard groups over (e.g. 'data')
    # true expert parallelism: shard the expert dim of the weights over this
    # axis (requires n_experts % axis_size == 0).  The dispatch buffer is then
    # resharded group-axis <-> expert-axis around the expert einsums — the
    # classic EP all-to-all — instead of moving expert WEIGHTS.
    expert_axis: str | None = None


def init_moe(generator: torch.Generator, d: int, cfg: MoEConfig, dtype
             ) -> dict:
    """Router (float32, as the reference's), per-expert ``(E, d, ff)`` /
    ``(E, ff, d)`` weights and, with shared experts, their dense MLP."""
    e, ff = cfg.n_experts, cfg.d_ff_expert
    p = {"router": normal(generator, (d, e), torch.float32,
                          init_scale("router", d)),
         "wi": normal(generator, (e, d, ff), dtype, init_scale("wi", d)),
         "wo": normal(generator, (e, ff, d), dtype, init_scale("wo", ff))}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["wg"] = normal(generator, (e, d, ff), dtype, init_scale("wg", d))
    if cfg.n_shared:
        ff_s = cfg.d_ff_shared or cfg.n_shared * ff
        p["shared"] = init_mlp(generator, d, ff_s, cfg.mlp_kind, dtype)
    return p


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(np.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def _route(params, xg, cfg: MoEConfig, cap: int):
    """xg: (G, gs, d) -> (gates, probs, e_flat, onehot, pos, keep): each
    token's top-k experts in token-major (token, k) order, its slot's rank
    within the expert and whether that rank is under the capacity."""
    logits = xg.float() @ params["router"]                        # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e_flat = idx.reshape(idx.shape[0], -1)                        # (G, gs·k)
    experts = torch.arange(cfg.n_experts, device=xg.device)
    onehot = (e_flat[..., None] == experts).to(torch.int32)       # (G, gs·k, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot                  # rank before me
    pos = ranks.gather(2, e_flat[..., None])[..., 0]
    return gates, probs, e_flat, onehot, pos, pos < cap


def _dispatch(params, xg, cfg: MoEConfig, cap: int):
    """xg: (G, gs, d) -> (expert buffer (E, G·cap, d), combine metadata).

    Slot ``(g, e, pos)`` lies at row ``g·cap + pos`` of expert ``e``; a slot
    ranked at ``cap`` or above goes to the spare last row, which is cut
    off."""
    g, gs, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    gates, probs, e_flat, onehot, pos, keep = _route(params, xg, cfg, cap)
    rows = g * cap
    slot = e_flat * rows + torch.arange(g, device=xg.device)[:, None] * cap \
        + torch.clamp(pos, max=cap - 1)                           # (G, gs·k)
    dest = torch.where(keep, slot, e * rows)                      # spare row

    buf = xg.new_zeros((e * rows + 1, d))
    src = xg.repeat_interleave(k, dim=1).reshape(g * gs * k, d)
    buf.index_copy_(0, dest.reshape(-1), src)
    meta = (slot, keep, gates, probs, onehot)
    return buf[:-1].view(e, rows, d), meta


def _combine(h, meta, g: int, gs: int, cfg: MoEConfig):
    """h: (E, G·cap, d) expert outputs -> (out (G·gs, d), aux (G,))."""
    slot, keep, gates, probs, onehot = meta
    d = h.shape[-1]
    out_slots = h.reshape(-1, d)[slot.reshape(-1)].view(g, gs * cfg.top_k, d)
    out_slots = torch.where(keep[..., None], out_slots, 0.0)
    w = gates.reshape(g, -1)[..., None].to(h.dtype)
    out = (out_slots * w).view(g, gs, cfg.top_k, d).sum(dim=2)
    # Switch-style load-balance aux (per group)
    me = probs.mean(dim=1)                                        # (G, E)
    ce = onehot.sum(dim=1).float() / max(gs * cfg.top_k, 1)
    aux = cfg.router_aux_weight * cfg.n_experts * (me * ce).sum(dim=-1)
    return out.reshape(g * gs, d), aux


def apply_moe(params: dict, x, cfg: MoEConfig, *, capacity: int | None = None):
    """x: (T, d) -> (out (T, d), aux_loss scalar).

    Dispatch is per group (``cfg.dispatch_groups``): ranking cumsums and
    scatters never cross a group boundary; the capacity comes from the
    group size.  Groups = 1 reproduces the classic single-pool behaviour.
    """
    t, d = x.shape
    g = cfg.dispatch_groups
    if t % g:
        g = 1
    gs = t // g
    cap = capacity if capacity is not None else _capacity(gs, cfg)
    ffn_params = {kk: params[kk] for kk in ("wi", "wg", "wo") if kk in params}

    mesh = mesh_of(x)
    if mesh is None:
        buf, meta = _dispatch(params, x.reshape(g, gs, d), cfg, cap)
        h = apply_mlp(ffn_params, buf, cfg.mlp_kind)             # (E, G·cap, d)
        out, auxs = _combine(h, meta, g, gs, cfg)
    else:
        out, auxs = _sharded(params, ffn_params, x.reshape(g, gs, d), cfg,
                             cap, mesh)
    if "shared" in params:
        out = out + apply_mlp(gather_fsdp(params["shared"], x), x,
                              cfg.mlp_kind)
    return out, auxs.mean()


def _axis_roles(mesh, axis, size: int, role: str) -> tuple:
    """``role`` on the mesh dim named ``axis`` when ``size`` splits over
    it; None on every other dim."""
    names = mesh.mesh_dim_names
    if axis is None or axis not in names or size % mesh.size(
            names.index(axis)):
        return (None,) * mesh.ndim
    return tuple(role if n == axis else None for n in names)


def _own_group_roles(xg) -> tuple:
    """"group" on each mesh dim over which the DTensor ``xg`` (G, gs, d)
    already shards its groups, as long as they still split evenly there;
    None elsewhere."""
    mesh, g, n = xg.device_mesh, xg.shape[0], 1
    out = []
    for m, role in enumerate(roles(xg, group=0)):
        if role is not None and g % (n * mesh.size(m)) == 0:
            n *= mesh.size(m)
        else:
            role = None
        out.append(role)
    return tuple(out)


def _sharded(params, ffn_params, xg, cfg: MoEConfig, cap: int, mesh):
    """``apply_moe``'s dispatch, expert products and combine on DTensors;
    ``xg`` (G, gs, d).  Returns (out (G·gs, d), aux (G,))."""
    g, gs, _ = xg.shape
    by_group = _axis_roles(mesh, cfg.group_axis, g, "group") \
        if cfg.group_axis else _own_group_roles(xg)
    # the buffer's rows are group-major within an expert: (E, G·cap, d)
    rows = layout(by_group, group=1)
    meta_pl = layout(by_group, group=0)

    def dispatch(xx, router):
        buf, meta = _dispatch({"router": router}, xx, cfg, cap)
        return (buf, *meta)

    buf, *meta = on_shards(dispatch, mesh, (xg, params["router"]),
                           (layout(by_group, group=0), layout(by_group)),
                           (rows,) + (meta_pl,) * 5)
    if cfg.expert_axis:
        by_expert = _axis_roles(mesh, cfg.expert_axis, cfg.n_experts,
                                "expert")
        both = tuple(e or r for e, r in zip(by_expert, by_group))
        buf = buf.redistribute(mesh, layout(both, expert=0, group=1))
    h = apply_mlp(gather_fsdp(ffn_params, buf), buf,
                  cfg.mlp_kind)                                 # (E, G·cap, d)
    return on_shards(
        lambda hh, *mm: _combine(hh, mm, hh.shape[1] // cap, gs, cfg),
        mesh, (h, *meta), (rows,) + (meta_pl,) * 5, (meta_pl, meta_pl))


def moe_flops(d: int, cfg: MoEConfig, tokens: int) -> float:
    n_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    active = 2.0 * n_mats * d * cfg.d_ff_expert * tokens * cfg.top_k
    router = 2.0 * d * cfg.n_experts * tokens
    shared = 0.0
    if cfg.n_shared:
        ff_s = cfg.d_ff_shared or cfg.n_shared * cfg.d_ff_expert
        shared = 2.0 * n_mats * d * ff_s * tokens
    return active + router + shared
