"""Checks that run on every rank of a gloo process group, for
``tests/test_torch_parallel.py`` (which spawns the ranks).

Each rank builds the same inputs from seeds, runs the port's sharded path
on its shards and the unsharded port on the whole inputs, and records, for
each check, the largest differences (or the traceback if the check raised)
in a JSON file of its own.  This module imports no JAX: the spawned ranks
import it by name.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh, mesh_shape_dict
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import (batch_specs, distribute_tree,
                                  hierarchical_grad_reduce, int8_all_reduce,
                                  param_specs, zero1_specs)
from repro_torch.parallel.sharding import P, _leaf_rule
from repro_torch.train.loop import make_train_step
from repro_torch.tree import SEP, flatten, tree_map_with_keys

WORLD = 4


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _err(got, want) -> float:
    return float((_full(got).detach().float() - want.detach().float())
                 .abs().max())


def _tree_err(got, want) -> dict:
    """Largest |difference| and largest |value| over the leaves."""
    g, w = flatten(got), flatten(want)
    assert g.keys() == w.keys()
    return {"err": max(_err(g[k], w[k]) for k in w),
            "scale": max(float(w[k].detach().float().abs().max()) for k in w)}


def _storage(t) -> list:
    """[bytes of the storage under ``t``'s local shard, bytes of the shard]:
    equal when the rank allocated its shard alone."""
    loc = t.to_local()
    return [loc.untyped_storage().nbytes(), loc.numel() * loc.element_size()]


def check_hierarchical(rank: int) -> dict:
    """(8, 8) gradients split as P("pod", "data") over (pod 2, data 2);
    each rank's (4, 4) block reduced to the mean of the four blocks."""
    mesh = make_mesh({"pod": 2, "data": 2}, "cpu")
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 8))
                         .astype(np.float32))
    pod, data = (int(c) for c in mesh.get_coordinate())
    local = g[4 * pod:4 * pod + 4, 4 * data:4 * data + 4]
    want = g.reshape(2, 4, 2, 4).mean(dim=(0, 2))
    out = {}
    for compress in (True, False):
        got = hierarchical_grad_reduce({"w": local}, mesh,
                                       compress_cross_pod=compress)["w"]
        out["int8" if compress else "float"] = _err(got, want)
    out["scale"] = float(want.abs().max())
    return out


def check_int8(rank: int) -> dict:
    """Each rank's own 1000 values; the int8 mean against the float mean,
    with each rank's own quantization steps (max |x| of a chunk / 127) and
    the shared steps (their sum) for the bound."""
    x = torch.from_numpy(np.random.default_rng(10 + rank).normal(
        0, 3.0, (1000,)).astype(np.float32))
    got = int8_all_reduce(x, None, mean=True, chunk=256)
    allx = torch.stack([torch.from_numpy(np.random.default_rng(10 + r).normal(
        0, 3.0, (1000,)).astype(np.float32)) for r in range(WORLD)])
    pad = torch.nn.functional.pad(allx, (0, (-1000) % 256))
    steps = pad.reshape(WORLD, -1, 256).abs().amax(-1) / 127.0   # (n, chunks)
    err = (got - allx.mean(0)).abs()
    err = torch.nn.functional.pad(err, (0, (-1000) % 256)).reshape(-1, 256)
    return {"err_by_chunk": err.amax(-1).tolist(),
            "max_step_by_chunk": steps.amax(0).tolist(),
            "shared_step_by_chunk": steps.sum(0).tolist()}


def check_moe(rank: int) -> dict:
    """The MoE with groups and experts over 'data' (4 ranks) against plain
    ``apply_moe``, the same four dispatch groups."""
    mesh = make_mesh({"data": WORLD, "model": 1}, "cpu")
    msd = mesh_shape_dict(mesh)
    plain = M.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=8.0, dispatch_groups=4)
    sharded = M.MoEConfig(**{**plain.__dict__, "group_axis": "data",
                             "expert_axis": "data"})
    params = M.init_moe(torch.Generator().manual_seed(0), 8, plain,
                        torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (32, 8))
                         .astype(np.float32))
    want, want_aux = M.apply_moe(params, x, plain)
    specs = tree_map_with_keys(
        lambda keys, t: _leaf_rule(("moe",) + keys, t.shape, msd, None,
                                   sharded.expert_axis), params)
    dp = distribute_tree(params, specs, mesh)
    dx = distribute_tree(x, P("data"), mesh)
    got, got_aux = M.apply_moe(dp, dx, sharded)
    return {"out": _err(got, want), "aux": _err(got_aux, want_aux),
            "wi_spec": list(specs["wi"]),
            "wi_local": list(dp["wi"].to_local().shape)}


def check_moe_batch(rank: int) -> dict:
    """The MoE with no ``group_axis`` (as ``build_cfg(opt=False)`` leaves
    qwen2-moe, mixtral and jamba) on tokens sharded over 'data' (4 ranks):
    the groups keep the batch's sharding, so each rank dispatches only its
    own group; with the experts over 'data' too, and without.  Against
    plain ``apply_moe``, with the shape of each rank's dispatch buffer."""
    mesh = make_mesh({"data": WORLD, "model": 1}, "cpu")
    msd = mesh_shape_dict(mesh)
    plain = M.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=8.0, dispatch_groups=4)
    params = M.init_moe(torch.Generator().manual_seed(1), 8, plain,
                        torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (32, 8))
                         .astype(np.float32))
    want, want_aux = M.apply_moe(params, x, plain)
    out = {"plain_buf": list(M._dispatch(
        params, x.reshape(4, 8, 8), plain, M._capacity(8, plain))[0].shape)}
    dispatch, seen = M._dispatch, []

    def recorded(*args):
        res = dispatch(*args)
        seen.append(list(res[0].shape))
        return res

    M._dispatch = recorded
    try:
        for name, expert_axis in (("replicated_experts", None),
                                  ("sharded_experts", "data")):
            cfg = M.MoEConfig(**{**plain.__dict__,
                                 "expert_axis": expert_axis})
            specs = tree_map_with_keys(
                lambda keys, t: _leaf_rule(("moe",) + keys, t.shape, msd,
                                           None, expert_axis), params)
            seen.clear()
            got, got_aux = M.apply_moe(distribute_tree(params, specs, mesh),
                                       distribute_tree(x, P("data"), mesh),
                                       cfg)
            out[name] = {"out": _err(got, want), "aux": _err(got_aux,
                                                              want_aux),
                         "local_bufs": list(seen)}
    finally:
        M._dispatch = dispatch
    return out


def _lm(arch: str, mesh, moe_dispatch_groups: int | None = None, **kw):
    msd = mesh_shape_dict(mesh)
    cfg = smoke_config(arch, tp=msd.get("model", 1), **kw)
    if moe_dispatch_groups:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch_groups=moe_dispatch_groups))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    dparams = distribute_tree(params, param_specs(cfg, params, msd), mesh)
    return cfg, msd, params, dparams


def _tokens(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))


def check_olmo(rank: int) -> dict:
    """Smoke olmo-1b on (data 2, model 2), batch pinned to 'data' and
    gradients sharded over it: a train step with ZeRO-1 moments, a
    prefill through the flash kernel's path and one decode step, against
    the unsharded port."""
    mesh = make_mesh({"data": 2, "model": 2}, "cpu")
    cfg, msd, params, dparams = _lm("olmo-1b", mesh, batch_axes=("data",),
                                    grad_shard=("data", 2))
    out = {}
    opt_cfg = AdamWConfig(lr=1e-3)
    toks = _tokens(cfg, 4, 32, 1)
    batch = {"tokens": toks, "labels": _tokens(cfg, 4, 32, 2)}
    # the constant lr of opt_cfg: a schedule's step 0 (warm-up) would be
    # lr 0, an update that leaves every weight as it was
    step = make_train_step(cfg, opt_cfg, num_microbatches=2)
    opt = adamw_init(params, opt_cfg)
    want_p, want_o, want_m = step(params, opt, batch)
    zs = zero1_specs(param_specs(cfg, params, msd), params, msd)
    dopt = distribute_tree(opt, {"m": zs, "v": zs, "step": P()}, mesh)
    got_p, got_o, got_m = step(dparams, dopt,
                               distribute_tree(batch, batch_specs(
                                   cfg, batch, msd), mesh))
    out["loss"] = [float(_full(got_m["loss"])), float(want_m["loss"])]
    out["grad_norm"] = [float(_full(got_m["grad_norm"])),
                        float(want_m["grad_norm"])]
    out["update"] = _tree_err(want_p, params)["err"]
    out["params"] = _tree_err(got_p, want_p)
    out["m"] = _tree_err(got_o["m"], want_o["m"])
    out["v"] = _tree_err(got_o["v"], want_o["v"])
    out["kept_layout"] = {
        name: all(a.placements == b.placements for a, b in zip(
            flatten(got).values(), flatten(was).values()))
        for name, got, was in (("params", got_p, dparams),
                               ("m", got_o["m"], dopt["m"]),
                               ("v", got_o["v"], dopt["v"]))}

    pcfg = cfg.replace(attn_impl_train="pallas")
    want, wcache = T.prefill(params, pcfg, {"tokens": toks}, 40)
    dtoks = distribute_tree(toks, P("data"), mesh)
    got, gcache = T.prefill(dparams, pcfg, {"tokens": dtoks}, 40)
    out["prefill"] = _err(got, want)
    out["prefill_scale"] = float(want.abs().max())
    nxt = want.argmax(-1).to(torch.int32)[:, None]
    want2, _ = T.decode_step(params, pcfg, nxt, wcache)
    got2, gcache = T.decode_step(dparams, pcfg,
                                 distribute_tree(nxt, P("data"), mesh),
                                 gcache)
    out["decode"] = _err(got2, want2)
    k = gcache["blocks"][0]["k"]
    out["cache_local"] = list(k.to_local().shape)
    out["cache_global"] = list(k.shape)
    out["cache_storage"] = _storage(k)
    return out


# Adam's first step moves a weight by lr g / (|g| + eps): where a gradient
# is near eps, a rounding of g in its last bits changes the update by a
# share of lr.  At the default eps (1e-8) one of the 8192 entries of
# blocks.0.mlp.wo has g = 1.1e-8, whose float32 sums in the reference and
# in the unsharded port already differ by 4%, and so do the two new weights
# by 1.1e-5; eps 1e-6 keeps every update a smooth function of g.
MICROBATCH_OPT = AdamWConfig(lr=1e-3, eps=1e-6)


def olmo_microbatch_inputs():
    """(config, initial weights, batch as NumPy) of the two-microbatch check
    below: smoke olmo-1b, its weights from seed 0, 8 rows of 32 tokens whose
    labels end in 1, 4, ..., 22 masked (-1) positions by row, so the rows of
    the first microbatch (0-3) keep more tokens than those of the second
    (4-7) and another grouping of the rows gives another loss."""
    cfg = smoke_config("olmo-1b", tp=1, batch_axes=("data",))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    for r in range(8):
        labels[r, 32 - (3 * r + 1):] = -1
    return cfg, params, {"tokens": tokens, "labels": labels}


def check_olmo_microbatches(rank: int) -> dict:
    """Two microbatches of a batch of 8 sharded over 4 'data' ranks (two
    rows a rank, fewer than the microbatches' four): the step against the
    unsharded port; rank 0 also writes the new weights (whole) to
    ``olmo_microbatches.npz`` beside its results, for the reference."""
    mesh = make_mesh({"data": WORLD, "model": 1}, "cpu")
    msd = mesh_shape_dict(mesh)
    cfg, params, batch = olmo_microbatch_inputs()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt_cfg = MICROBATCH_OPT
    step = make_train_step(cfg, opt_cfg, num_microbatches=2)
    want_p, _, want_m = step(params, adamw_init(params, opt_cfg), batch)
    dparams = distribute_tree(params, param_specs(cfg, params, msd), mesh)
    zs = zero1_specs(param_specs(cfg, params, msd), params, msd)
    dopt = distribute_tree(adamw_init(params, opt_cfg),
                           {"m": zs, "v": zs, "step": P()}, mesh)
    dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
    got_p, _, got_m = step(dparams, dopt, dbatch)
    full = {k: _full(v).detach().numpy() for k, v in flatten(got_p).items()}
    if rank == 0:
        np.savez(os.path.join(OUT_DIR, "olmo_microbatches.npz"), **full)
    return {"loss": [float(_full(got_m["loss"])), float(want_m["loss"])],
            "grad_norm": [float(_full(got_m["grad_norm"])),
                          float(want_m["grad_norm"])],
            "update": _tree_err(want_p, params)["err"],
            "params": _tree_err(got_p, want_p),
            "tokens_local": list(dbatch["tokens"].to_local().shape)}


def check_mamba(rank: int) -> dict:
    """Smoke mamba2-1.3b prefill and one decode step on (data 1, model 2),
    over ranks 0 and 1 (ranks 2 and 3 are not in the mesh and skip it)."""
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))
    if rank >= 2:
        return {}
    cfg, msd, params, dparams = _lm("mamba2-1.3b", mesh)
    toks = _tokens(cfg, 2, 32, 3)
    want, wcache = T.prefill(params, cfg, {"tokens": toks}, 40)
    batch = {"tokens": toks}
    got, gcache = T.prefill(dparams, cfg, distribute_tree(
        batch, batch_specs(cfg, batch, msd), mesh), 40)
    nxt = want.argmax(-1).to(torch.int32)[:, None]
    want2, _ = T.decode_step(params, cfg, nxt, wcache)
    got2, _ = T.decode_step(dparams, cfg, distribute_tree(nxt, P(), mesh),
                            gcache)
    ssm = gcache["blocks"][0]["ssm"]
    return {"prefill": _err(got, want), "decode": _err(got2, want2),
            "prefill_scale": float(want.abs().max()),
            "ssm_local": list(ssm.to_local().shape),
            "ssm_global": list(ssm.shape), "ssm_storage": _storage(ssm)}


def check_decode_past_end(rank: int) -> dict:
    """Smoke olmo-1b on (data 2, model 2): a prompt that fills the cache,
    then two decode steps past its end, sharded against the unsharded
    port, with the float32 and the int8 cache.  Each step writes the last
    slot (the reference's clamp), on the sharded path too."""
    mesh = make_mesh({"data": 2, "model": 2}, "cpu")
    out = {}
    for name, quant in (("float", False), ("int8", True)):
        cfg, msd, params, dparams = _lm("olmo-1b", mesh,
                                        batch_axes=("data",),
                                        kv_quant=quant)
        toks = _tokens(cfg, 4, 16, 5)
        key = "k_q" if quant else "k"
        want, wcache = T.prefill(params, cfg, {"tokens": toks}, 16)
        got, gcache = T.prefill(dparams, cfg, {
            "tokens": distribute_tree(toks, P("data"), mesh)}, 16)
        was = wcache["blocks"][0][key][:, :, -1].clone()
        errs, wrote = [], []
        for step in range(2):
            nxt = _tokens(cfg, 4, 1, 6 + step)
            want, wcache = T.decode_step(params, cfg, nxt, wcache)
            got, gcache = T.decode_step(
                dparams, cfg, distribute_tree(nxt, P("data"), mesh), gcache)
            errs.append(_err(got, want))
        wk, gk = wcache["blocks"][0][key], _full(gcache["blocks"][0][key])
        out[name] = {"decode": max(errs), "scale": float(want.abs().max()),
                     "last_slot": _err(gk[:, :, -1], wk[:, :, -1]),
                     "last_slot_written": not torch.equal(
                         gk[:, :, -1], was)}
    return out


def _mamba_step(mesh, arch: str = "mamba2-1.3b", rows: int = 4,
                microbatches: int = 1, zero1_axes: tuple = (),
                **kw) -> dict:
    """One train step of smoke ``arch`` on ``mesh`` (``rows`` rows of 32
    tokens in ``microbatches`` microbatches) against the unsharded step on
    the same weights; the moments laid out as the parameters, or by
    ``zero1_specs`` over ``zero1_axes`` (ZeRO-1)."""
    cfg, msd, params, dparams = _lm(arch, mesh, **kw)
    batch = {"tokens": _tokens(cfg, rows, 32, 6),
             "labels": _tokens(cfg, rows, 32, 7)}
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt_cfg, num_microbatches=microbatches)
    want_p, _, want_m = step(params, adamw_init(params, opt_cfg), batch)
    specs = param_specs(cfg, params, msd)
    if zero1_axes:
        specs = zero1_specs(specs, params, msd, axes=zero1_axes)
    dopt = distribute_tree(adamw_init(params, opt_cfg),
                           {"m": specs, "v": specs, "step": P()}, mesh)
    got_p, _, got_m = step(dparams, dopt, distribute_tree(
        batch, batch_specs(cfg, batch, msd), mesh))
    out = {"loss": [float(_full(got_m["loss"])), float(want_m["loss"])],
           "grad_norm": [float(_full(got_m["grad_norm"])),
                         float(want_m["grad_norm"])],
           "update": _tree_err(want_p, params)["err"],
           "params": _tree_err(got_p, want_p)}
    if "mamba" in dparams["blocks"][0]:
        a_log = dparams["blocks"][0]["mamba"]["a_log"]
        out["a_log_local"] = list(a_log.to_local().shape)
    return out


def check_mamba_train(rank: int) -> dict:
    """One train step of smoke mamba2-1.3b against the unsharded step on
    the same weights: on (data 1, model 2) over ranks 0 and 1, the SSD's
    backward on each rank's heads under ``local_map``; then on (data 2,
    model 2), batch over 'data', over all four."""
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))
    out = {"tp": _mamba_step(mesh) if rank < 2 else {}}
    out["dp_tp"] = _mamba_step(make_mesh({"data": 2, "model": 2}, "cpu"),
                               batch_axes=("data",))
    return out


# the reference's pure data-parallel layout (``layout="dp"``, the opt
# layout of olmo-1b, mamba2-1.3b and musicgen-large): parameters
# replicated, ZeRO-1 moments over ('data', 'model'), the batch over every
# mesh dim; (mesh, arch) by case
DP_CASES = {
    "olmo": ({"data": 2, "model": 2}, "olmo-1b"),
    "mamba": ({"data": 2, "model": 2}, "mamba2-1.3b"),
    "olmo_multi_pod": ({"pod": 2, "data": 2, "model": 1}, "olmo-1b"),
}


def check_dp_train(rank: int) -> dict:
    """One train step in the reference's ``dp`` layout for each of
    ``DP_CASES`` (four rows, one a rank), against the unsharded step on the
    same weights: every gradient is reduced once, into its moments' shard,
    before the norm and the update (over 'pod' the shard is then
    all-reduced)."""
    out = {}
    for name, (shape, arch) in DP_CASES.items():
        mesh = make_mesh(shape, "cpu")
        out[name] = _mamba_step(mesh, arch, layout="dp",
                                batch_axes=tuple(shape),
                                zero1_axes=("data", "model"))
    return out


@contextlib.contextmanager
def _pinned_rows(out: list):
    """Appends to ``out`` the local rows (dim 0) of every DTensor that
    ``transformer._pin_batch`` returns while the context is open."""
    pin = T._pin_batch

    def record(cfg, x):
        y = pin(cfg, x)
        if isinstance(y, DTensor):
            out.append(int(y.to_local().shape[0]))
        return y

    T._pin_batch = record
    try:
        yield
    finally:
        T._pin_batch = pin


def check_jamba_fsdp_train(rank: int) -> dict:
    """One train step of smoke jamba (MoE, Mamba, and FSDP: the big weights
    sharded over 'data' too) on (pod 2, data 2, model 1) with two rows
    (``batch_axes`` pod and data, as jamba train_4k's 16-row microbatches
    on the 512-rank mesh): the input batch splits over 'pod' alone, the
    pinned hidden stream over all four ranks (1, 0, 1, 0 rows by rank);
    against the unsharded step: each layer's FSDP weights are gathered
    over 'data' at its entry."""
    mesh = make_mesh({"pod": 2, "data": 2, "model": 1}, "cpu")
    rows: list = []
    with _pinned_rows(rows):
        out = _mamba_step(mesh, "jamba-1.5-large-398b", rows=2,
                          batch_axes=("pod", "data"))
    return dict(out, pinned_rows=sorted(set(rows)))


def _merge_split_rows(mesh) -> dict:
    """``shards.merge_rows`` and ``split_rows`` of a (2, 8, 4) tensor whose
    two rows split over (pod 2, data 2) (1, 0, 1, 0 rows by rank): the
    merged (16, 4) rows evenly, 4 a rank, equal to the plain reshape, the
    split back equal to the input, and the gradient of a function of the
    merged rows equal to plain autograd's."""
    from repro_torch.parallel.shards import merge_rows, split_rows
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 8, 4)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (16, 4)).astype(np.float32))
    pl = (Shard(0), Shard(0), Replicate())
    dx = distribute_tensor(x, mesh, pl).detach().requires_grad_()
    rows = merge_rows(dx)
    back = split_rows(rows * 2.0, dx)
    (rows.full_tensor() * w).sum().backward()
    return {"merged": _err(rows, x.reshape(16, 4)),
            "split": _err(back, x * 2.0), "grad": _err(dx.grad, w.reshape(
                2, 8, 4)),
            "rows_local": int(rows.to_local().shape[0]),
            "back_local": int(back.to_local().shape[0])}


def check_uneven_pin(rank: int) -> dict:
    """Train steps on (pod 2, data 2, model 1), ``batch_axes`` pod and
    data, four rows in two microbatches of two: the input batch splits
    over 'pod' alone (``batch_specs``), while the pinned hidden stream
    splits each microbatch's two rows over all four ranks, as the
    reference's ``_pin_batch`` does (1, 0, 1, 0 rows by rank).  Smoke
    olmo-1b, and smoke qwen2-moe with four dispatch groups, whose 2 x 32
    rows go to one group a rank (``merge_rows``) and back; each against
    the unsharded step on the same weights.  Then ``merge_rows`` and
    ``split_rows`` alone."""
    mesh = make_mesh({"pod": 2, "data": 2, "model": 1}, "cpu")
    out = {}
    for name, arch, kw in (("olmo", "olmo-1b", {}),
                           ("moe", "qwen2-moe-a2.7b",
                            {"moe_dispatch_groups": 4})):
        rows: list = []
        with _pinned_rows(rows):
            out[name] = _mamba_step(mesh, arch, rows=4, microbatches=2,
                                    batch_axes=("pod", "data"), **kw)
        out[name]["pinned_rows"] = sorted(set(rows))
    out["rows"] = _merge_split_rows(mesh)
    return out


class _Largest(TorchDispatchMode):
    """Records the bytes of the largest plain tensor, off the meta device,
    that an op makes while the mode is on."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not hasattr(t, "to_local") \
                    and t.device.type != "meta":
                self.most = max(self.most, t.numel() * t.element_size())
        return out


def check_cache_alloc(rank: int) -> dict:
    """A fresh cache on (data 4, model 1), batch over 'data', for a ring
    buffer (mixtral's window), an int8 KV cache (qwen1.5-32b) and Mamba
    with attention (jamba): each leaf's values against the plain cache, its
    storage against its shard's bytes, and the largest tensor made while
    it was allocated."""
    mesh = make_mesh({"data": WORLD, "model": 1}, "cpu")
    out = {}
    for arch in ("mixtral-8x7b", "qwen1.5-32b", "jamba-1.5-large-398b"):
        cfg = smoke_config(arch, batch_axes=("data",))
        with _Largest() as made:
            sharded = T.init_cache(cfg, 4, 40, device="cpu", mesh=mesh)
        got, want = ({k.replace(SEP, "/"): t for k, t in flatten(c).items()}
                     for c in (sharded, T.init_cache(cfg, 4, 40,
                                                     device="cpu")))
        ts = {k: t for k, t in got.items() if hasattr(t, "to_local")}
        out[arch] = {
            "largest_made": made.most,
            "keys": sorted(ts), "pos": got[[k for k in got
                                            if k not in ts][0]],
            "values_equal": all(torch.equal(t.full_tensor(), want[k])
                                for k, t in ts.items()),
            "batch_sharded": sorted(k for k, t in ts.items()
                                    if t.to_local().shape[1] * WORLD
                                    == t.shape[1] and t.dim() > 2),
            "storage": {k: _storage(t) for k, t in ts.items()}}
    return out


def check_gqa(rank: int) -> dict:
    """Smoke yi-6b (4 q heads, 2 kv heads) on (data 1, model 4): the kv
    heads duplicated to 4 for tp 4 (``AttnDims``), one q and one kv head a
    rank; prefill through the flash kernel's path and one decode step
    against the unsharded port on the same (tp 4) weights."""
    mesh = make_mesh({"data": 1, "model": WORLD}, "cpu")
    cfg, msd, params, dparams = _lm("yi-6b", mesh, attn_impl_train="pallas")
    toks = _tokens(cfg, 2, 32, 5)
    want, wcache = T.prefill(params, cfg, {"tokens": toks}, 40)
    batch = {"tokens": toks}
    got, gcache = T.prefill(dparams, cfg, distribute_tree(
        batch, batch_specs(cfg, batch, msd), mesh), 40)
    nxt = want.argmax(-1).to(torch.int32)[:, None]
    want2, _ = T.decode_step(params, cfg, nxt, wcache)
    got2, _ = T.decode_step(dparams, cfg, distribute_tree(
        nxt, P(), mesh), gcache)
    k = gcache["blocks"][0]["k"]
    return {"prefill": _err(got, want), "decode": _err(got2, want2),
            "kv_local": list(k.to_local().shape), "kv_global": list(k.shape),
            "wq_local": list(dparams["blocks"][0]["attn"]["wq"]
                             .to_local().shape)}


# the loss's heads on (data 2, model 2): (vocab, head placements); the
# vocab split over 'model' (256 columns a rank), a vocab of 511, which
# 'model' does not divide, so the head is split on d (its logits whole
# over the vocab), and the FSDP head, split on d over 'data' as well
LOSS_HEADS = {"vocab": (512, "R,S1"), "d": (511, "R,S0"),
              "fsdp": (512, "S0,S1")}


def loss_inputs(vocab: int):
    """(hidden (4, 32, 16), labels (4, 32), head (16, vocab), norm scale
    (16,)) from seeds: labels -1 at random, on the first and last column
    of each 256-column shard, and all -1 in positions 8-15 (one chunk of
    8)."""
    rng = np.random.default_rng(27)
    hidden = rng.normal(0, 1, (4, 32, 16)).astype(np.float32)
    labels = rng.integers(0, vocab, (4, 32))
    labels[rng.random((4, 32)) < 0.2] = -1
    labels[:, 8:16] = -1
    labels[0, :4] = [0, 255, 256, vocab - 1]
    labels[3, 28:] = [vocab - 1, 256, 255, 0]
    head = rng.normal(0, 0.5, (16, vocab)).astype(np.float32)
    scale = rng.normal(1, 0.1, (16,)).astype(np.float32)
    return [torch.from_numpy(a) for a in (hidden, labels.astype(np.int32),
                                          head, scale)]


def check_loss_heads(rank: int) -> dict:
    """``chunked_cross_entropy`` (chunks of 8, an rms final norm) with the
    hidden state's rows over 'data', for each head of ``LOSS_HEADS``,
    against plain on the same inputs: the loss and the gradients of the
    hidden state, the head and the norm's scale."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.common import chunked_cross_entropy

    mesh = make_mesh({"data": 2, "model": 2}, "cpu")
    out = {}
    for name, (vocab, head_pl) in LOSS_HEADS.items():
        hidden, labels, head, scale = loss_inputs(vocab)

        def loss_grads(h, lab, w, sc):
            leaves = [t.requires_grad_() for t in (h, w, sc)]
            loss = chunked_cross_entropy(h, lab, w, chunk=8,
                                         norm_kind="rms",
                                         norm_params={"scale": sc})
            return loss, torch.autograd.grad(loss, leaves)

        want, want_g = loss_grads(hidden, labels, head, scale)
        rows = [Shard(0), Replicate()]
        put = lambda t, pl: distribute_tensor(t, mesh, pl)  # noqa: E731
        got, got_g = loss_grads(
            put(hidden, rows), put(labels, rows),
            put(head, [Replicate() if p == "R" else Shard(int(p[1]))
                       for p in head_pl.split(",")]),
            put(scale, [Replicate(), Replicate()]))
        out[name] = {"loss": [float(_full(got).detach()),
                              float(want.detach())],
                     "head_local": list(got_g[1].to_local().shape)}
        for key, g, w in zip(("hidden", "head", "scale"), got_g, want_g):
            out[name][key] = {"err": _err(g, w),
                              "scale": float(w.abs().max())}
    return out


CHECKS = {"hierarchical": check_hierarchical, "int8": check_int8,
          "moe": check_moe, "moe_batch": check_moe_batch, "olmo": check_olmo, "mamba": check_mamba,
          "mamba_train": check_mamba_train, "gqa": check_gqa,
          "cache_alloc": check_cache_alloc,
          "olmo_microbatches": check_olmo_microbatches,
          "jamba_fsdp_train": check_jamba_fsdp_train,
          "uneven_pin": check_uneven_pin,
          "loss_heads": check_loss_heads, "dp_train": check_dp_train,
          "decode_past_end": check_decode_past_end}

# the directory ``run`` writes its results to (a check's larger outputs go
# there too)
OUT_DIR = ""


def run(rank: int, init_file: str, out_dir: str) -> None:
    """Entry of a spawned rank: every check in turn, each one's numbers or
    traceback written to ``out_dir/rank<rank>.json``."""
    global OUT_DIR
    OUT_DIR = out_dir
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    try:
        for name, fn in CHECKS.items():
            try:
                results[name] = fn(rank)
            except Exception:      # recorded for the test to report
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)


@contextlib.contextmanager
def one_rank_group(tmp_dir, backend: str = "gloo"):
    """A process group of this process alone (gloo, or NCCL on the card; its
    store a file under ``tmp_dir``), destroyed on exit."""
    store = dist.FileStore(os.path.join(str(tmp_dir), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()
