"""Checks of the sharded path that run on every rank of a four-rank
process group: gloo on the CPU (``tests/test_torch_parallel.py`` spawns the
ranks through ``tests/torch_parallel_workers.py``) and NCCL on four cards
(``chip_smoke.py --cards 4``), one copy for both.

Each rank builds the same inputs from seeds, runs the port's sharded path
on its shards and the unsharded port on the whole inputs, and returns, for
each check, the largest differences; ``verdicts`` holds them to the
tolerances of their tests.  ``DEVICE`` is where the checks put their
tensors and meshes ("cpu" for gloo, "cuda" for NCCL, each rank on its own
current card).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os

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
from repro_torch.models.common import init_scale
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import (batch_specs, distribute_tree,
                                  hierarchical_grad_reduce, int8_all_reduce,
                                  param_specs, zero1_specs)
from repro_torch.parallel.sharding import P, _leaf_rule
from repro_torch.train.loop import make_train_step
from repro_torch.tree import SEP, flatten, tree_map, tree_map_with_keys

WORLD = 4
DEVICE = "cpu"
# where a check writes its larger outputs (``check_olmo_microbatches``)
OUT_DIR = ""


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(DEVICE)


_MESHES: dict = {}


def mesh_of_shape(shape: dict):
    """``make_mesh(shape, DEVICE)``, made once a device and shape and then
    reused: under NCCL every mesh makes communicators, which hold card
    memory until the process group ends.  Every rank asks for the same
    meshes in the same order, as ``new_group`` needs."""
    key = (DEVICE, tuple(shape.items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, DEVICE)
    return _MESHES[key]


def two_rank_mesh():
    """A (data 1, model 2) mesh of ranks 0 and 1 alone (made by every
    rank), once a device."""
    key = (DEVICE, "ranks 0-1")
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh(DEVICE, torch.arange(2).reshape(1, 2),
                                  mesh_dim_names=("data", "model"))
    return _MESHES[key]


def _dev(tree):
    """``tree``'s tensors on ``DEVICE``."""
    return tree_map(lambda t: t.to(DEVICE) if isinstance(t, torch.Tensor)
                    else t, tree)


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
    mesh = mesh_of_shape({"pod": 2, "data": 2})
    g = _t(np.random.default_rng(0).normal(0, 1, (8, 8))
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
    x = _t(np.random.default_rng(10 + rank).normal(
        0, 3.0, (1000,)).astype(np.float32))
    got = int8_all_reduce(x, None, mean=True, chunk=256)
    allx = torch.stack([_t(np.random.default_rng(10 + r).normal(
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
    mesh = mesh_of_shape({"data": WORLD, "model": 1})
    msd = mesh_shape_dict(mesh)
    plain = M.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=8.0, dispatch_groups=4)
    sharded = M.MoEConfig(**{**plain.__dict__, "group_axis": "data",
                             "expert_axis": "data"})
    params = _dev(M.init_moe(torch.Generator().manual_seed(0), 8, plain,
                             torch.float32))
    x = _t(np.random.default_rng(0).normal(0, 1, (32, 8))
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
    mesh = mesh_of_shape({"data": WORLD, "model": 1})
    msd = mesh_shape_dict(mesh)
    plain = M.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=8.0, dispatch_groups=4)
    params = _dev(M.init_moe(torch.Generator().manual_seed(1), 8, plain,
                             torch.float32))
    x = _t(np.random.default_rng(1).normal(0, 1, (32, 8))
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
    params = _dev(T.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu"))
    dparams = distribute_tree(params, param_specs(cfg, params, msd), mesh)
    return cfg, msd, params, dparams


def _tokens(cfg, b: int, s: int, seed: int) -> torch.Tensor:
    return _t(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))


def check_olmo(rank: int) -> dict:
    """Smoke olmo-1b on (data 2, model 2), batch pinned to 'data' and
    gradients sharded over it: a train step with ZeRO-1 moments, a
    prefill through the flash kernel's path and one decode step, against
    the unsharded port."""
    mesh = mesh_of_shape({"data": 2, "model": 2})
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
    out["moments"] = _moments(got_o, want_o)
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
    mesh = mesh_of_shape({"data": WORLD, "model": 1})
    msd = mesh_shape_dict(mesh)
    cfg, params, batch = olmo_microbatch_inputs()
    params = _dev(params)
    batch = {k: _t(v) for k, v in batch.items()}
    opt_cfg = MICROBATCH_OPT
    step = make_train_step(cfg, opt_cfg, num_microbatches=2)
    want_p, want_o, want_m = step(params, adamw_init(params, opt_cfg),
                                  batch)
    dparams = distribute_tree(params, param_specs(cfg, params, msd), mesh)
    zs = zero1_specs(param_specs(cfg, params, msd), params, msd)
    dopt = distribute_tree(adamw_init(params, opt_cfg),
                           {"m": zs, "v": zs, "step": P()}, mesh)
    dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
    got_p, got_o, got_m = step(dparams, dopt, dbatch)
    full = {k: _full(v).detach().cpu().numpy()
            for k, v in flatten(got_p).items()}
    if rank == 0:
        np.savez(os.path.join(OUT_DIR, "olmo_microbatches.npz"), **full)
    return {"loss": [float(_full(got_m["loss"])), float(want_m["loss"])],
            "grad_norm": [float(_full(got_m["grad_norm"])),
                          float(want_m["grad_norm"])],
            "update": _tree_err(want_p, params)["err"],
            "params": _tree_err(got_p, want_p),
            "moments": _moments(got_o, want_o),
            "tokens_local": list(dbatch["tokens"].to_local().shape)}


def check_mamba(rank: int) -> dict:
    """Smoke mamba2-1.3b prefill and one decode step on (data 1, model 2),
    over ranks 0 and 1 (ranks 2 and 3 are not in the mesh and skip it)."""
    mesh = two_rank_mesh()
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
    mesh = mesh_of_shape({"data": 2, "model": 2})
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
    # eps 1e-6 (see MICROBATCH_OPT): at 1e-8 smoke jamba's blocks.1.mamba.wz
    # has an entry with g = -4.9e-10 unsharded and -2.9e-10 sharded (float32
    # sums of terms near 1e-2 in another order), which Adam's slope of
    # lr / eps = 1e5 turns into new weights 1.8e-5 apart on the CPU and
    # 1.5e-4 on four cards; the moments, linear in g, hold each leaf's
    # gradient whatever eps is (``_moments``)
    opt_cfg = MICROBATCH_OPT
    step = make_train_step(cfg, opt_cfg, num_microbatches=microbatches)
    want_p, want_o, want_m = step(params, adamw_init(params, opt_cfg), batch)
    specs = param_specs(cfg, params, msd)
    if zero1_axes:
        specs = zero1_specs(specs, params, msd, axes=zero1_axes)
    dopt = distribute_tree(adamw_init(params, opt_cfg),
                           {"m": specs, "v": specs, "step": P()}, mesh)
    got_p, got_o, got_m = step(dparams, dopt, distribute_tree(
        batch, batch_specs(cfg, batch, msd), mesh))
    out = {"loss": [float(_full(got_m["loss"])), float(want_m["loss"])],
           "grad_norm": [float(_full(got_m["grad_norm"])),
                         float(want_m["grad_norm"])],
           "update": _tree_err(want_p, params)["err"],
           "params": _tree_err(got_p, want_p),
           "moments": _moments(got_o, want_o),
           "worst": _worst_leaves(got_p, want_p, got_o["m"], want_o["m"])}
    if "mamba" in dparams["blocks"][0]:
        a_log = dparams["blocks"][0]["mamba"]["a_log"]
        out["a_log_local"] = list(a_log.to_local().shape)
    return out


def _moments(got_o, want_o) -> dict:
    """Each leaf's moments after the step against the unsharded step's:
    [largest |difference| of m, largest |m|, the same of v, then the sums
    of squares of m's difference, of m, of v's difference and of v].  The
    first moment is linear in the gradient and the second in its square,
    so a gradient entry off by a share shows here at any eps, where the
    new weight moves by lr g / (sqrt(v) + eps) and barely sees an entry
    far below eps.  Each sharded leaf is gathered whole on every rank
    (``full_tensor``, a collective), so every rank calls this."""
    out = {}
    for key in ("m", "v"):
        g, w = flatten(got_o[key]), flatten(want_o[key])
        for k in w:
            gw = _full(g[k]).detach().float()
            ww = w[k].detach().float()
            out.setdefault(k.replace(SEP, "/"), []).append(
                [float((gw - ww).abs().max()), float(ww.abs().max()),
                 float(((gw - ww) ** 2).sum()), float((ww ** 2).sum())])
    return {k: [a[0], a[1], b[0], b[1], a[2], a[3], b[2], b[3]]
            for k, (a, b) in out.items()}


def _worst_leaves(got_p, want_p, got_m, want_m, n: int = 3) -> list:
    """The ``n`` weights whose new values differ most between the two
    steps: the leaf, the |difference|, and at that entry both new weights
    and both first moments (the step's first moment is (1 - beta1) times
    the clipped gradient, so this shows the gradients that moved it)."""
    gp, wp, gm, wm = (flatten(t) for t in (got_p, want_p, got_m, want_m))
    rows = []
    for k in wp:
        diff = (_full(gp[k]).detach().float() - wp[k].detach().float()).abs()
        i = int(diff.reshape(-1).argmax())
        rows.append({"leaf": k.replace(SEP, "/"), "err": float(
            diff.reshape(-1)[i]), "index": i, "new": [
            float(_full(t).detach().reshape(-1)[i]) for t in (gp[k], wp[k])],
            "m": [float(_full(t).detach().reshape(-1)[i])
                  for t in (gm[k], wm[k])]})
    return sorted(rows, key=lambda r: -r["err"])[:n]


def check_mamba_train(rank: int) -> dict:
    """One train step of smoke mamba2-1.3b against the unsharded step on
    the same weights: on (data 1, model 2) over ranks 0 and 1, the SSD's
    backward on each rank's heads under ``local_map``; then on (data 2,
    model 2), batch over 'data', over all four."""
    mesh = two_rank_mesh()
    out = {"tp": _mamba_step(mesh) if rank < 2 else {}}
    out["dp_tp"] = _mamba_step(mesh_of_shape({"data": 2, "model": 2}),
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
        mesh = mesh_of_shape(shape)
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
    mesh = mesh_of_shape({"pod": 2, "data": 2, "model": 1})
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
    x = _t(np.random.default_rng(5).normal(
        0, 1, (2, 8, 4)).astype(np.float32))
    w = _t(np.random.default_rng(6).normal(
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
    mesh = mesh_of_shape({"pod": 2, "data": 2, "model": 1})
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
    mesh = mesh_of_shape({"data": WORLD, "model": 1})
    out = {}
    for arch in ("mixtral-8x7b", "qwen1.5-32b", "jamba-1.5-large-398b"):
        cfg = smoke_config(arch, batch_axes=("data",))
        with _Largest() as made:
            sharded = T.init_cache(cfg, 4, 40, device=DEVICE, mesh=mesh)
        got, want = ({k.replace(SEP, "/"): t for k, t in flatten(c).items()}
                     for c in (sharded, T.init_cache(cfg, 4, 40,
                                                     device=DEVICE)))
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
    mesh = mesh_of_shape({"data": 1, "model": WORLD})
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
    return [_t(a) for a in (hidden, labels.astype(np.int32),
                                          head, scale)]


def check_loss_heads(rank: int) -> dict:
    """``chunked_cross_entropy`` (chunks of 8, an rms final norm) with the
    hidden state's rows over 'data', for each head of ``LOSS_HEADS``,
    against plain on the same inputs: the loss and the gradients of the
    hidden state, the head and the norm's scale."""
    from repro_torch.models.common import chunked_cross_entropy

    mesh = mesh_of_shape({"data": 2, "model": 2})
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


# smoke archs on (data 1, model 4) whose production cells run on four cards:
# (arch, config overrides, prompt length, cache length); mixtral's window of
# 16 under a 40-token prompt makes its ring cache wrap
MESH4_SERVE = {"qwen1.5-32b": ({}, 40, 48),
               "mixtral-8x7b": ({"swa_window": 16}, 40, 48)}
MESH4_DECODE_STEPS = 4


def check_mesh4_serve(rank: int) -> dict:
    """Smoke qwen1.5-32b (MHA, one head a rank, QKV bias, the int8 KV
    cache) and smoke mixtral-8x7b (GQA duplicated to one kv head a rank,
    a sliding window whose ring cache wraps, the MoE top-2) on (data 1,
    model 4): the prefill through the flash kernel's path and
    ``MESH4_DECODE_STEPS`` greedy decode steps against the unsharded port
    on the same (tp 4) weights."""
    mesh = mesh_of_shape({"data": 1, "model": WORLD})
    out = {}
    for arch, (kw, prompt, max_len) in MESH4_SERVE.items():
        cfg, msd, params, dparams = _lm(arch, mesh, attn_impl_train="pallas",
                                        **kw)
        toks = _tokens(cfg, 2, prompt, 9)
        want, wcache = T.prefill(params, cfg, {"tokens": toks}, max_len)
        batch = {"tokens": toks}
        got, gcache = T.prefill(dparams, cfg, distribute_tree(
            batch, batch_specs(cfg, batch, msd), mesh), max_len)
        errs, scale = [_err(got, want)], float(want.abs().max())
        for _ in range(MESH4_DECODE_STEPS):
            nxt = want.argmax(-1).to(torch.int32)[:, None]
            want, wcache = T.decode_step(params, cfg, nxt, wcache)
            got, gcache = T.decode_step(dparams, cfg, distribute_tree(
                nxt, P(), mesh), gcache)
            errs.append(_err(got, want))
            scale = max(scale, float(want.abs().max()))
        leaves = {k.split(SEP)[-1]: t for k, t in
                  flatten(gcache["blocks"]).items()}
        key = "k_q" if cfg.kv_quant else "k"
        out[arch] = {"prefill": errs[0], "decode": max(errs[1:]),
                     "scale": scale, "kv_local": list(
                         leaves[key].to_local().shape),
                     "kv_global": list(leaves[key].shape),
                     "ring": "slot_pos" in leaves,
                     "pos": gcache["pos"]}
    return out


# the shard-seeded weights' smoke configs on (data 1, model 4): qwen1.5-32b
# as it is, mixtral-8x7b with 8 q over 4 kv heads (its smoke 4 over 2 would
# duplicate kv heads at tp 4, which the scheme refuses; its production 32
# over 8 does not)
SHARD_INIT = {"qwen1.5-32b": {}, "mixtral-8x7b": {"n_heads": 8,
                                                  "n_kv_heads": 4}}


def check_shard_init(rank: int) -> dict:
    """``shard_init.init_shards`` on (data 1, model 4), two layers: each
    rank's shard of every leaf equals its slice of ``init_whole``'s tree,
    bit for bit, and so does the gathered tree; then the prefill and
    ``MESH4_DECODE_STEPS`` decode steps of the sharded tree against the
    unsharded port on the whole one (the four-card parity run's path)."""
    from repro_torch.models import shard_init as SI
    from repro_torch.parallel.shards import _shard_box

    mesh = mesh_of_shape({"data": 1, "model": WORLD})
    msd = mesh_shape_dict(mesh)
    out = {}
    for arch, kw in SHARD_INIT.items():
        cfg = smoke_config(arch, tp=WORLD, n_layers=2,
                           attn_impl_train="pallas", **kw)
        whole = SI.init_whole(cfg, msd, 3, dtype=torch.float32,
                              device=DEVICE)
        shards = SI.init_shards(cfg, mesh, 3, dtype=torch.float32,
                                device=DEVICE)
        w, g = flatten(whole), flatten(shards)
        sliced, gathered = [], []
        for k, t in g.items():
            shape, start = _shard_box(t.shape, mesh, t.placements)
            box = tuple(slice(a, a + n) for a, n in zip(start, shape))
            sliced.append(torch.equal(t.to_local(), w[k][box]))
            gathered.append(torch.equal(t.full_tensor(), w[k]))
        toks = _tokens(cfg, 2, 24, 11)
        want, wcache = T.prefill(whole, cfg, {"tokens": toks}, 32)
        got, gcache = T.prefill(shards, cfg, {"tokens": distribute_tree(
            toks, P(), mesh)}, 32)
        errs = [_err(got, want)]
        for _ in range(MESH4_DECODE_STEPS):
            nxt = want.argmax(-1).to(torch.int32)[:, None]
            want, wcache = T.decode_step(whole, cfg, nxt, wcache)
            got, gcache = T.decode_step(shards, cfg, distribute_tree(
                nxt, P(), mesh), gcache)
            errs.append(_err(got, want))
        out[arch] = {"leaves": len(g), "sliced_equal": all(sliced),
                     "gathered_equal": all(gathered),
                     "wq_local": list(g[SEP.join(("blocks", "0", "attn",
                                                  "wq"))]
                                      .to_local().shape),
                     "prefill": errs[0], "decode": max(errs[1:]),
                     "scale": float(want.abs().max())}
    return out


# ------------------------------------------------------------ MoE routes ---

ROUTE = M._route


class RouteRecorder:
    """A pass-through around the MoE FFN's router (``moe._route``, what
    ``apply_moe`` dispatches by) that keeps every call's routes: the expert
    of each (token, slot), whether the slot is kept under the capacity,
    and each token's router logits ((tokens, experts), float32, as
    ``_route`` computes them).  On the sharded path it sees each rank's
    own groups."""

    def __init__(self):
        self.routes: list = []

    def __call__(self, params, xg, cfg, cap):
        out = ROUTE(params, xg, cfg, cap)
        self.routes.append((out[2], out[5], (xg.float() @ params["router"])
                            .reshape(-1, cfg.n_experts)))
        return out


@contextlib.contextmanager
def recording_routes(recorder: RouteRecorder):
    """``recorder`` in place of ``moe._route`` while the context is open."""
    M._route = recorder
    try:
        yield recorder
    finally:
        M._route = ROUTE


def route_changes(got: list, want: list, calls: list, layers: int, k: int,
                  margin_tol) -> list:
    """Between two runs' recorded routes (``RouteRecorder.routes``: the same
    model calls in the same order, ``layers`` MoE layers each, the i-th
    call's rows ``calls[i]`` tokens long; ``want``'s with the router's
    logits), for each call: the (token, slot)s whose expert differs
    (``expert_slots``) and those whose capacity keep alone differs
    (``keep_slots``, the rank of a slot counting the earlier slots of its
    expert); and for each row whose last token's route differs in some
    layer, at the first such layer: the layer, the margins in ``want``'s
    router logits between the expert each changed slot took in ``want`` and
    the one it took in ``got`` (none where the keep alone changed), the
    tolerance ``margin_tol(layer, the token's logits in want)``, and
    ``near_tie``: an expert changed, and every margin lies within the
    tolerance, as a perturbation of the router's input within the
    compared logits' own tolerance can move it."""
    out = []
    for i, tokens_per_row in enumerate(calls):
        res = {"expert_slots": 0, "keep_slots": 0, "rows": []}
        seen = set()
        for layer in range(layers):
            ge, gk = (t.reshape(-1) for t in got[i * layers + layer][:2])
            we, wk, wl = want[i * layers + layer]
            we, wk = we.reshape(-1), wk.reshape(-1)
            expert = ge != we
            keep = (gk != wk) & ~expert
            res["expert_slots"] += int(expert.sum())
            res["keep_slots"] += int(keep.sum())
            for row in range(ge.numel() // k // tokens_per_row):
                t = (row + 1) * tokens_per_row - 1
                slots = range(t * k, (t + 1) * k)
                changed = [j for j in slots if bool(expert[j])]
                if row in seen or not (changed or any(bool(keep[j])
                                                      for j in slots)):
                    continue
                seen.add(row)
                lg = wl[t].float()
                margins = [abs(float(lg[we[j]] - lg[ge[j]])) for j in changed]
                tol = float(margin_tol(layer, lg))
                res["rows"].append({
                    "row": row, "layer": layer, "margins": margins,
                    "tol": tol, "keep_only": not changed,
                    "near_tie": bool(changed) and max(margins) <= tol})
        out.append(res)
    return out


def judge_rows(errs: list, tol: float, changes: dict) -> list:
    """Each compared row's verdict: "held" within ``tol``, "excused" past
    it when its last token's route changed first by a near tie
    (``route_changes``' call ``changes``), else "failed"."""
    near = {c["row"] for c in changes["rows"] if c["near_tie"]}
    return ["held" if e <= tol else "excused" if r in near else "failed"
            for r, e in enumerate(errs)]


def _served_rows(params, cfg, toks, max_len: int, wrap, tokens=None) -> dict:
    """A prefill of ``toks`` and ``MESH4_DECODE_STEPS`` greedy steps (or
    steps on ``tokens``), the routes recorded with the router's logits:
    every call's logits (whole), the tokens fed, the routes."""
    with recording_routes(RouteRecorder()) as rec:
        logits, cache = T.prefill(params, cfg, {"tokens": wrap(toks)},
                                  max_len)
        out = {"logits": [_full(logits)], "tokens": []}
        for i in range(MESH4_DECODE_STEPS):
            nxt = out["logits"][-1].argmax(-1).to(torch.int32)[:, None] \
                if tokens is None else tokens[i]
            out["tokens"].append(nxt)
            logits, cache = T.decode_step(params, cfg, wrap(nxt), cache)
            out["logits"].append(_full(logits))
    out["routes"] = rec.routes
    return out


def check_route_excuse(rank: int) -> dict:
    """Smoke mixtral-8x7b on (data 1, model 4) as ``check_mesh4_serve``
    runs it, the routes recorded on both paths, every compared row (the
    prefill's and each decode step's, fed the unsharded run's tokens)
    judged by ``judge_rows`` at the serving checks' 1e-5, a margin within
    1e-5 of the token's largest |router logit| a near tie: the sharded
    port against the unsharded one on the same weights ("same"), and with
    the sharded copy's routers moved by N(0, 1) times their own scale
    ("moved"), which changes routes by more than a near tie, so that its
    rows past the tolerance, though their routes changed, are refused."""
    mesh = mesh_of_shape({"data": 1, "model": WORLD})
    kw, prompt, max_len = MESH4_SERVE["mixtral-8x7b"]
    cfg, msd, params, dparams = _lm("mixtral-8x7b", mesh,
                                    attn_impl_train="pallas", **kw)
    toks = _tokens(cfg, 2, prompt, 9)
    gen = torch.Generator().manual_seed(12)

    def moved_router(keys, t):
        if keys[-1] != "router":
            return t
        noise = torch.randn(t.shape, generator=gen).to(t.device)
        return t + noise * init_scale("router", t.shape[-2])

    moved = tree_map_with_keys(moved_router, params)
    moved = distribute_tree(moved, param_specs(cfg, moved, msd), mesh)

    def wrap(t):
        return distribute_tree(t, batch_specs(cfg, {"tokens": t}, msd)
                               ["tokens"], mesh)

    want = _served_rows(params, cfg, toks, max_len, lambda t: t)
    out = {}
    for name, p in (("same", dparams), ("moved", moved)):
        got = _served_rows(p, cfg, toks, max_len, wrap, want["tokens"])
        changes = route_changes(
            got["routes"], want["routes"],
            [prompt] + [1] * MESH4_DECODE_STEPS, cfg.n_layers,
            cfg.moe.top_k,
            lambda layer, lg: 1e-5 * max(1.0, float(lg.abs().max())))
        judged = []
        for g, w, c in zip(got["logits"], want["logits"], changes):
            errs = (g.float() - w.float()).abs().amax(-1).tolist()
            judged.append(judge_rows(errs, 1e-5, c))
        out[name] = {"judged": judged,
                     "changed_rows": [[c["row"] for c in ch["rows"]]
                                      for ch in changes],
                     "expert_slots": sum(c["expert_slots"] for c in changes),
                     "keep_slots": sum(c["keep_slots"] for c in changes),
                     "margins": [r for c in changes for r in c["rows"]]}
    return out


# ------------------------------------------------------ bf16 train cells ---

# the archs of the four-card train cells at smoke size, two layers, with
# heads that tp 4 neither pads nor duplicates (one kv head a rank, as
# yi-6b's 4 at tp 4), each on both meshes the cells run on
TRAIN_CELLS = {"yi-6b": {"n_heads": 8, "n_kv_heads": 4},
               "minitron-8b": {"n_heads": 8, "n_kv_heads": 4},
               "musicgen-large": {"n_heads": 8, "n_kv_heads": 8}}
TRAIN_MESHES = {"tp4": {"data": 1, "model": 4},
                "dp2_tp2": {"data": 2, "model": 2}}
TRAIN_CELL_ROWS = 4
TRAIN_CELL_SEQ = 32
TRAIN_CELL_MICROBATCHES = 2
TRAIN_CELL_STEPS = 2


def train_cell_cfg(arch: str, mesh_shape: dict):
    """Smoke ``arch`` laid out as ``build_cfg`` lays out a train cell on
    ``mesh_shape`` (tp the 'model' size, the batch over 'data'), with remat
    (the production config's), two layers and ``TRAIN_CELLS``' heads."""
    return smoke_config(arch, tp=mesh_shape["model"], batch_axes=("data",),
                        remat=True, n_layers=2, **TRAIN_CELLS[arch])


def train_batch(cfg, rows: int, seq: int, seed: int) -> dict:
    """Seeded token ids and labels of ``rows`` x ``seq`` (x codebooks),
    the last 5 labels of each row masked (-1), on ``DEVICE``."""
    rng = np.random.default_rng(seed)
    shape = (rows, seq) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[:, -5:] = -1
    return {"tokens": _t(rng.integers(1, cfg.vocab, shape).astype(np.int32)),
            "labels": _t(labels)}


def train_layout(params, opt) -> list:
    """Every weight's and moment's placements, in one order."""
    return [t.placements for t in (*flatten(params).values(),
                                   *flatten(opt["m"]).values(),
                                   *flatten(opt["v"]).values())]


def train_parity(cfg, mesh, batch: dict, *, steps: int, microbatches: int,
                 seed: int = 0, unsharded_on: int | None = None,
                 count: bool = False) -> dict:
    """``steps`` bfloat16 train steps of ``cfg`` at the reference's optimizer
    config (``AdamWConfig(moment_dtype=cfg.opt_dtype)``) on ``mesh``: the
    weights drawn shard by shard (``shard_init.init_shards``), the moments
    laid out by ``zero1_specs`` (``shard_init.zero1_state``), ``batch``
    (whole, the same on every rank) by ``batch_specs``; against the same
    steps of the unsharded port on the same values
    (``shard_init.init_whole``), taken on every rank, or on rank
    ``unsharded_on`` alone while the others wait.  Returns the sharded and
    unsharded losses and grad norms by step, whether every leaf kept its
    layout, and where the unsharded side ran, the new weights
    (``_bf16_weights``) and moments (``_moments``) against it; with
    ``count``, the first step's collectives (``CollectiveCounter``)."""
    from repro_torch.launch.commcount import CollectiveCounter
    from repro_torch.models import shard_init as SI
    msd = mesh_shape_dict(mesh)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype)
    step = make_train_step(cfg, opt_cfg, num_microbatches=microbatches)
    params = SI.init_shards(cfg, mesh, seed, torch.bfloat16, DEVICE)
    opt = SI.zero1_state(cfg, params, mesh, opt_cfg)
    dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
    was = train_layout(params, opt)
    out = {"lr": opt_cfg.lr, "layers": cfg.n_layers, "rows":
           int(batch["tokens"].shape[0]), "data": msd.get("data", 1),
           "tokens_local": list(dbatch["tokens"].to_local().shape),
           "kept_layout": True, "loss": [], "grad_norm": []}
    for i in range(steps):
        if count and i == 0:
            with CollectiveCounter() as counter:
                params, opt, met = step(params, opt, dbatch)
            out["collectives"] = counter.result()
        else:
            params, opt, met = step(params, opt, dbatch)
        out["loss"].append([float(_full(met["loss"]))])
        out["grad_norm"].append([float(_full(met["grad_norm"]))])
        out["kept_layout"] &= train_layout(params, opt) == was
    if unsharded_on is not None and dist.get_rank() != unsharded_on:
        dist.barrier()
        # the gathers ``_bf16_weights`` and ``_moments`` make, in their order
        for tree in (params, opt["m"], opt["v"]):
            for t in flatten(tree).values():
                _full(t)
        return out
    first = SI.init_whole(cfg, msd, seed, torch.bfloat16, DEVICE)
    want_p, want_o = first, adamw_init(first, opt_cfg)
    for i in range(steps):
        want_p, want_o, met = step(want_p, want_o, batch)
        out["loss"][i].append(float(met["loss"]))
        out["grad_norm"][i].append(float(met["grad_norm"]))
    out["update"] = _tree_err(want_p, first)["err"]
    del first
    if unsharded_on is not None:
        dist.barrier()
    out["weights"] = _bf16_weights(params, want_p, opt_cfg.lr)
    out["moments"] = _moments(opt, want_o)
    return out


def check_train_cells(rank: int) -> dict:
    """Smoke yi-6b, minitron-8b and musicgen-large in bfloat16 on (data 1,
    model 4) and (data 2, model 2): ``TRAIN_CELL_STEPS`` steps of
    ``TRAIN_CELL_MICROBATCHES`` microbatches (the float32 microbatch sum,
    each gradient reduced once into its ZeRO-1 moments' shard) against the
    unsharded steps on the same weights (``train_parity``), and the first
    step's collectives.  On the CPU each rank computes on one thread: the
    four ranks share the host's cores, and at smoke size a rank's many
    threads cost it ten times the step."""
    out, threads = {}, torch.get_num_threads()
    if DEVICE == "cpu":
        torch.set_num_threads(1)
    try:
        for arch in TRAIN_CELLS:
            for name, shape in TRAIN_MESHES.items():
                cfg = train_cell_cfg(arch, shape)
                out[f"{arch} {name}"] = train_parity(
                    cfg, mesh_of_shape(shape),
                    train_batch(cfg, TRAIN_CELL_ROWS, TRAIN_CELL_SEQ, 12),
                    steps=TRAIN_CELL_STEPS,
                    microbatches=TRAIN_CELL_MICROBATCHES, count=True)
    finally:
        torch.set_num_threads(threads)
    return out


CHECKS = {"hierarchical": check_hierarchical, "int8": check_int8,
          "moe": check_moe, "moe_batch": check_moe_batch, "olmo": check_olmo,
          "mamba": check_mamba,
          "mamba_train": check_mamba_train, "gqa": check_gqa,
          "cache_alloc": check_cache_alloc,
          "olmo_microbatches": check_olmo_microbatches,
          "jamba_fsdp_train": check_jamba_fsdp_train,
          "uneven_pin": check_uneven_pin,
          "loss_heads": check_loss_heads, "dp_train": check_dp_train,
          "decode_past_end": check_decode_past_end,
          "mesh4_serve": check_mesh4_serve, "shard_init": check_shard_init,
          "route_excuse": check_route_excuse,
          "train_cells": check_train_cells}


# ------------------------------------------------------------- verdicts ---
# The one definition of each check's tolerances: the tests of
# ``tests/test_torch_parallel.py`` hold the gloo run by it, case by case,
# and ``chip_smoke.py --cards 4`` the NCCL run.

def _close(pair, rtol: float = 1e-5) -> bool:
    """``np.testing.assert_allclose(got, want, rtol)``'s rule."""
    got, want = pair
    return abs(got - want) <= rtol * abs(want)


def _moments_ok(moments: dict, l2: dict | None = None) -> bool:
    """With ``l2`` (a bfloat16 step, ``BF16_STEP_TOL``): each leaf's moments
    (``_moments``) within ``l2["m"]`` / ``l2["v"]`` relative L2 of the
    unsharded step's, those of the float32 leaves whose gradients are
    cancelling sums (``FLOAT32_LEAVES``) within ``l2["sums"]``, and the
    whole tree's within ``l2["m"]`` / ``l2["v"]``
    (``tests/test_torch_bf16_train.py``'s rule and numbers).

    Without it (float32), each leaf's moments within 1e-5 of their own largest
    value, or of ``MOMENT_FLOOR`` times the tree's largest where the leaf's
    own lie below that (its square for v, which holds g squared): a leaf
    whose gradient is a long sum that cancels to a small value (Mamba's
    per-head ``a_log`` and ``dt_bias``, 1e-3 to 1e-4 of the largest
    gradients) keeps the rounding of its terms, not of its value.  A share
    of a gradient lost or counted twice moves its leaf's moments by that
    share, 1e4 times the tolerance or more."""
    if l2 is not None:
        def lim(leaf: str, name: str) -> float:
            sums = leaf.split("/")[-1] in FLOAT32_LEAVES
            return l2["sums"] if sums else l2[name]
        tree = [sum(r[i] for r in moments.values()) for i in range(4, 8)]
        return all(r[4] <= lim(k, "m") ** 2 * r[5]
                   and r[6] <= lim(k, "v") ** 2 * r[7]
                   for k, r in moments.items()) \
            and tree[0] <= l2["m"] ** 2 * tree[1] \
            and tree[2] <= l2["v"] ** 2 * tree[3]
    top_m = max(r[1] for r in moments.values())
    top_v = max(r[3] for r in moments.values())
    return all(me <= 1e-5 * max(ms, MOMENT_FLOOR * top_m)
               and ve <= 1e-5 * max(vs, MOMENT_FLOOR ** 2 * top_v)
               for me, ms, ve, vs, *_ in moments.values())


# the floor of a leaf's moment scale, as a share of the tree's largest
MOMENT_FLOOR = 1e-3


def _step_ok(r: dict) -> bool:
    """A train step against the unsharded one on the same weights: loss and
    grad norm within 1e-5 relative, an update of about the lr (100 times
    the tolerance, so a wrong update shows), new weights within 1e-5, and
    each leaf's moments within 1e-5 (``_moments_ok``; float32 sums taken
    in another order, across ranks, move a gradient's last few bits)."""
    return (_close(r["loss"]) and _close(r["grad_norm"])
            and r["update"] >= 5e-4
            and r["params"]["err"] <= 1e-5 * max(1.0, r["params"]["scale"])
            and _moments_ok(r["moments"]))


# A bfloat16 train step sharded against unsharded: the tolerances
# ``tests/test_torch_bf16_train.py`` argues for the port's step against the
# reference's (its docstring), as the two differ in the same way: each
# side rounds its own bfloat16 products, here the row-parallel products'
# partial sums on each rank and their sum across ranks against one card's
# float32 sum rounded once.  The loss within 5e-4 relative from the same
# state (1e-3 after a step from each side's own state); the grad norm
# within 4e-3 a layer; every weight within 2 lr a step plus one bfloat16
# step of its leaf's largest |value| (AdamW moves a weight at most
# lr |m / sqrt(v)| <= 1.0003 lr a step in the first three, so a gradient
# rounded to the other sign moves it 2 lr, once a step); the weights past
# 0.5 lr plus a bfloat16 step of their own value (an update whose sign
# flipped) under 0.5% of the elements a step; each leaf's moments, and the
# tree's, within 0.08 relative L2, those of float32 leaves of cancelling
# sums 0.15.
BF16_STEP_TOL = {"loss": 5e-4, "loss_own": 1e-3, "grad_norm": 4e-3,
                 "lr_a_step": 2.0, "flips": 0.005, "m": 0.08, "v": 0.08,
                 "sums": 0.15}
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip", "router")


def _bf16_weights(got_p, want_p, lr: float) -> dict:
    """The sharded step's new weights against the unsharded one's (every
    rank gathers each leaf, ``full_tensor``): {leaf: [largest |difference|,
    one bfloat16 step of the leaf's largest |value| (0 for a float32
    leaf)]}, and the elements past 0.5 lr plus one bfloat16 step of their
    own value, of all."""
    g, w = flatten(got_p), flatten(want_p)
    leaves, past, total = {}, 0, 0
    for k in w:
        gw, ww = _full(g[k]).detach().float(), w[k].detach().float()
        err = (gw - ww).abs()
        bf16 = w[k].dtype == torch.bfloat16
        own = torch.where(ww != 0, torch.exp2(torch.floor(torch.log2(
            ww.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7),
            torch.zeros_like(ww)) if bf16 else torch.zeros_like(ww)
        top = float(ww.abs().max())
        leaves[k.replace(SEP, "/")] = [
            float(err.max()),
            2.0 ** (math.floor(math.log2(top)) - 7) if bf16 and top else 0.0]
        past += int((err > 0.5 * lr + own).sum())
        total += err.numel()
    return {"leaves": leaves, "past": past, "total": total}


def _bf16_step_ok(r: dict) -> bool:
    """``train_parity``'s numbers within ``BF16_STEP_TOL``."""
    tol, lr, steps = BF16_STEP_TOL, r["lr"], len(r["loss"])
    return (all(_close(pair, tol["loss"] if i == 0 else tol["loss_own"])
                for i, pair in enumerate(r["loss"]))
            and all(_close(pair, tol["grad_norm"] * r["layers"])
                    for pair in r["grad_norm"])
            and r["update"] >= 0.5 * lr
            and all(err <= tol["lr_a_step"] * steps * lr + step
                    for err, step in r["weights"]["leaves"].values())
            and r["weights"]["past"]
            <= tol["flips"] * steps * r["weights"]["total"]
            and _moments_ok(r["moments"], tol))


def _serve_ok(r: dict) -> bool:
    """Prefill and decode logits within 1e-5 (float32; the row-parallel
    products sum the ranks' partial sums, another order than one rank's)."""
    return r["prefill"] <= 1e-5 and r["decode"] <= 1e-5


def _cases(name: str, rank: int, r: dict) -> dict:
    """{case: whether rank ``rank``'s numbers ``r`` of check ``name`` pass}
    for each case of the check (a parametrised test's cases, else one)."""
    n = WORLD
    if name == "hierarchical":
        return {"reduce": r["int8"] <= r["scale"] / 64 and r["float"] <= 1e-6}
    if name == "int8":
        return {"bound": all(
            e <= (n + 1) * s / (2 * n) + 1e-6 and e <= 4 * b
            for e, b, s in zip(r["err_by_chunk"], r["max_step_by_chunk"],
                               r["shared_step_by_chunk"]))}
    if name == "moe":
        return {"ep": r["wi_spec"] == ["data"] and r["wi_local"] == [1, 8, 16]
                and r["out"] <= 1e-6 and r["aux"] <= 1e-6}
    if name == "moe_batch":
        return {k: r["plain_buf"] == [4, 4 * 32, 8]
                and r[k]["local_bufs"] == [[4, 32, 8]]
                and r[k]["out"] <= 1e-6 and r[k]["aux"] <= 1e-6
                for k in ("replicated_experts", "sharded_experts")}
    if name == "olmo":
        return {"train": _step_ok(r) and all(
                    r[k]["err"] <= 1e-5 * r[k]["scale"] for k in ("m", "v"))
                and r["kept_layout"] == {"params": True, "m": True,
                                         "v": True},
                "serve": _serve_ok(r) and r["cache_global"] == [1, 4, 40, 4, 16]
                and r["cache_local"] == [1, 2, 40, 2, 16]
                and r["cache_storage"] == [1 * 2 * 40 * 2 * 16 * 4] * 2}
    if name == "decode_past_end":
        return {k: c["decode"] <= 1e-5 * max(1.0, c["scale"])
                and c["last_slot"] == 0 and c["last_slot_written"]
                for k, c in r.items()}
    if name == "cache_alloc":
        key = {"mixtral-8x7b": "blocks/0/slot_pos", "qwen1.5-32b":
               "blocks/0/k_q", "jamba-1.5-large-398b": "blocks/4/k"}
        return {arch: key[arch] in got["keys"]
                and got["pos"] == 0 and got["values_equal"]
                and got["batch_sharded"] == [k for k in got["keys"]
                                             if not k.endswith("slot_pos")]
                and all(a == b for a, b in got["storage"].values())
                and got["largest_made"] == max(b for _, b in
                                               got["storage"].values())
                for arch, got in r.items()}
    if name == "mamba":
        return {"serve": r == {} if rank >= 2 else (
            _serve_ok(r) and r["ssm_global"] == [1, 2, 8, 16, 16]
            and r["ssm_local"] == [1, 2, 4, 16, 16]
            and r["ssm_storage"] == [1 * 2 * 4 * 16 * 16 * 4] * 2)}
    if name == "mamba_train":
        return {"tp": r["tp"] == {} if rank >= 2 else (
                    _step_ok(r["tp"]) and r["tp"]["a_log_local"] == [1, 4]),
                "dp_tp": _step_ok(r["dp_tp"])
                and r["dp_tp"]["a_log_local"] == [1, 4]}
    if name == "jamba_fsdp_train":
        return {"train": _step_ok(r) and r["pinned_rows"] == [1 - rank % 2]}
    if name == "dp_train":
        return {case: _step_ok(r[case]) for case in DP_CASES}
    if name == "uneven_pin":
        rows = r["rows"]
        return {**{k: _step_ok(r[k]) and r[k]["pinned_rows"] == [1 - rank % 2]
                   for k in ("olmo", "moe")},
                "rows": rows["rows_local"] == 4
                and rows["back_local"] == 1 - rank % 2
                and rows["merged"] == rows["split"] == rows["grad"] == 0.0}
    if name == "loss_heads":
        local = {"vocab": [16, 256], "d": [8, 511], "fsdp": [8, 256]}
        return {h: _close(r[h]["loss"]) and r[h]["head_local"] == local[h]
                and all(r[h][k]["err"] <= 1e-5 * r[h][k]["scale"]
                        for k in ("hidden", "head", "scale"))
                for h in LOSS_HEADS}
    if name == "gqa":
        return {"serve": r["kv_global"] == [1, 2, 40, 4, 16]
                and r["kv_local"] == [1, 2, 40, 1, 16]
                and r["wq_local"] == [1, 64, 16] and _serve_ok(r)}
    if name == "olmo_microbatches":
        return {"train": _step_ok(r) and r["tokens_local"] == [2, 32]}
    if name == "mesh4_serve":
        return {arch: _serve_ok(c) and c["kv_local"][3] == 1
                and c["kv_global"][3] == WORLD
                and c["pos"] == MESH4_SERVE[arch][1] + MESH4_DECODE_STEPS
                and c["ring"] == ("swa_window" in MESH4_SERVE[arch][0])
                and (not c["ring"] or c["kv_global"][2]
                     == MESH4_SERVE[arch][0]["swa_window"])
                for arch, c in r.items()}
    if name == "shard_init":
        return {arch: c["sliced_equal"] and c["gathered_equal"]
                and c["wq_local"][2] * WORLD
                == SHARD_INIT[arch].get("n_heads", 4) * 16
                and _serve_ok(c) for arch, c in r.items()}
    if name == "route_excuse":
        moved = r["moved"]
        return {"same": all(v != "failed" for call in r["same"]["judged"]
                            for v in call),
                # the routes moved, and a row past the tolerance whose own
                # route changed is refused all the same
                "moved": moved["expert_slots"] > 0 and any(
                    v == "failed" and row in rows
                    for call, rows in zip(moved["judged"],
                                          moved["changed_rows"])
                    for row, v in enumerate(call))}
    if name == "train_cells":
        return {case: _bf16_step_ok(c) and c["kept_layout"]
                and c["tokens_local"][0] * c["data"] == c["rows"]
                for case, c in r.items()}
    raise KeyError(name)


def verdict(name: str, ranks: list, case: str | None = None):
    """None if every rank's numbers of check ``name`` (``ranks``: rank 0's,
    ..., rank 3's) pass its tolerances (``case``'s alone, when given), else
    {rank: its numbers, or its error}; every rank of the int8 all-reduce
    holds the same mean."""
    def ok(rank, r):
        if "error" in r:
            return False
        cases = _cases(name, rank, r)
        return cases[case] if case is not None else all(cases.values())
    bad = [rank for rank, r in enumerate(ranks) if not ok(rank, r)]
    if name == "int8" and not bad and any(r != ranks[0] for r in ranks):
        bad = list(range(len(ranks)))
    return None if not bad else {
        rank: ranks[rank].get("error", ranks[rank]) for rank in bad}


def verdicts(results: dict) -> dict:
    """{check: ``verdict`` of every case} for ``results`` ({check: [rank
    0's numbers, ..., rank 3's]})."""
    return {name: verdict(name, ranks) for name, ranks in results.items()}
