"""The port's distribution layer against the JAX package's.

* Spec parity: for every arch, both production meshes ({data 16, model 16}
  and {pod 2, data 16, model 16}), base and opt configs, train and decode,
  the port's ``param_specs``, ``zero1_specs`` (axes as
  ``launch/dryrun.py:56-57`` picks them), ``batch_specs``, ``cache_specs``
  (every applicable ``SHAPES`` cell) and ``validate_divisibility`` over the
  port's meta-device shapes equal the reference's over ``eval_shape``, leaf
  by leaf and path by path, as tuples.  The shapes of both packages are the
  same tree too.
* The fake backend: on the 256- and 512-rank production meshes, in one
  process, ``distribute_tree`` over meta params gives local shapes whose
  bytes are the shard arithmetic of ``tests/test_distribution.py:58-78``,
  under 8e9 bytes a device for every arch.
* Gloo, four processes (``torch_parallel_workers.run``; store files under
  the test's temporary directory): a two-microbatch train step over a
  batch sharded on four 'data' ranks against the unsharded port and the
  reference's step, the hierarchical reduce within
  ``scale / 64`` of the mean over the data-parallel shards (int8 across
  pods; float within 1e-6), the int8 all-reduce within its analytic bound,
  expert-parallel MoE equal to plain, and sharded smoke olmo-1b (train
  step, prefill, decode) and mamba2-1.3b (prefill, decode and a train
  step) against the unsharded port.
"""
import dataclasses
import json
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.parallel as JPAR
from repro.configs import smoke_config as j_smoke_config
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
from repro.configs import ARCH_IDS, SHAPES, cell_applicable
from repro.launch import specs as JS
from repro.launch.optconfig import build_cfg as j_build_cfg
from repro.parallel.sharding import _path_names as j_path_names
import repro_torch.parallel as TPAR
from repro_torch.device import resolve_device
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     mesh_shape_dict)
from repro_torch.launch.optconfig import build_cfg
from repro_torch.parallel import int8_all_reduce
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import P, PartitionSpec, _path_names
from repro_torch.train import make_train_step
from repro_torch.tree import flatten, tree_leaves, tree_map_with_keys

import torch_parallel_workers as W

MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}

# fields that name layouts and not shapes: the initialisers of both
# packages read none of them, so configs that differ only in these share
# their parameter shapes (and the cache of them below)
_LAYOUT_FIELDS = dict(batch_axes=(), layout="tp", fsdp=False, kv_quant=False,
                      grad_shard=(), attn_impl_train="chunked")


def _shape_key(cfg):
    moe = cfg.moe and dataclasses.replace(cfg.moe, dispatch_groups=1,
                                          group_axis=None, expert_axis=None)
    return repr(cfg.replace(moe=moe, **_LAYOUT_FIELDS))


@pytest.fixture(scope="module")
def param_shapes():
    """(reference eval_shape tree, port meta tree) by shape key, built once
    a key."""
    cache = {}

    def get(jc, tc):
        key = _shape_key(tc)
        if key not in cache:
            cache[key] = (JS.params_shapes(jc), TS.params_shapes(tc))
        return cache[key]
    return get


def _j_flat(tree) -> dict:
    """{reference path names: spec or shape as a tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {j_path_names(p): tuple(v) if isinstance(v, JP) else
            (tuple(v.shape), str(v.dtype)) for p, v in flat}


def _t_flat(tree) -> dict:
    """The same for a port tree of specs or tensors (``pos`` an int)."""
    out = {}

    def walk(t, keys=()):
        if isinstance(t, PartitionSpec):
            out[_path_names(keys)] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, keys + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, keys + (i,))
        elif isinstance(t, torch.Tensor):
            out[_path_names(keys)] = (tuple(t.shape),
                                      str(t.dtype).removeprefix("torch."))
        else:
            out[_path_names(keys)] = ((), "int32")
    walk(tree)
    return out


def _bad(entries) -> list:
    return [(tuple(p), tuple(s), tuple(sp)) for p, s, sp in entries]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, param_shapes):
    n_cells = 0
    for mesh in MESHES.values():
        for opt in (False, True):
            for kind in ("train", "decode"):
                jc = j_build_cfg(arch, mesh, opt=opt, kind=kind)
                tc = build_cfg(arch, mesh, opt=opt, kind=kind)
                jp, tp = param_shapes(jc, tc)
                assert _t_flat(tp) == _j_flat(jp)
                js = JPAR.param_specs(jc, jp, mesh)
                ts = TPAR.param_specs(tc, tp, mesh)
                assert _t_flat(ts) == _j_flat(js)
                axes = ("data", "model") if jc.layout in ("dp", "fsdp2d") \
                    else ("data",)
                jz = JPAR.zero1_specs(js, jp, mesh, axes=axes)
                tz = TPAR.zero1_specs(ts, tp, mesh, axes=axes)
                assert _t_flat(tz) == _j_flat(jz)
                for jspec, tspec in ((js, ts), (jz, tz)):
                    assert _bad(TPAR.validate_divisibility(tspec, tp, mesh)) \
                        == _bad(JPAR.validate_divisibility(jspec, jp, mesh))
                for cell in SHAPES.values():
                    if not cell_applicable(jc, cell):
                        continue
                    if cell.kind == "train":
                        jb = JS.train_input_specs(jc, cell)
                        tb = TS.train_input_specs(tc, cell)
                    else:
                        jb = JS.prefill_input_specs(jc, cell)
                        tb = TS.prefill_input_specs(tc, cell)
                    assert _t_flat(tb) == _j_flat(jb)
                    assert _t_flat(TPAR.batch_specs(tc, tb, mesh)) == \
                        _j_flat(JPAR.batch_specs(jc, jb, mesh))
                    if cell.kind == "train":
                        continue
                    jd = JS.decode_input_specs(jc, cell)
                    td = TS.decode_input_specs(tc, cell)
                    assert _t_flat(td) == _j_flat(jd)
                    jcs, tcs = JS.cache_shapes(jc, cell), \
                        TS.cache_shapes(tc, cell)
                    assert _t_flat(tcs) == _j_flat(jcs)
                    jcspec = JPAR.cache_specs(jc, jcs, mesh)
                    tcspec = TPAR.cache_specs(tc, tcs, mesh)
                    assert _t_flat(tcspec) == _j_flat(jcspec)
                    assert _bad(TPAR.validate_divisibility(tcspec, tcs, mesh)) \
                        == _bad(JPAR.validate_divisibility(jcspec, jcs, mesh))
                    n_cells += 1
    assert n_cells > 0


def test_validate_divisibility_reports_in_reference_order():
    """A spec that does not divide is reported leaf by leaf in the
    reference's (sorted-key) order, with its names, shape and spec."""
    mesh = {"data": 3, "model": 16}
    shapes = {"b": torch.empty((4, 32), device="meta"),
              "a": (torch.empty((5,), device="meta"),)}
    specs = {"b": P("data", "model"), "a": (P("data"),)}
    jshapes = {"b": jax.ShapeDtypeStruct((4, 32), np.float32),
               "a": (jax.ShapeDtypeStruct((5,), np.float32),)}
    jspecs = {"b": JP("data", "model"), "a": (JP("data"),)}
    got = _bad(TPAR.validate_divisibility(specs, shapes, mesh))
    assert got == _bad(JPAR.validate_divisibility(jspecs, jshapes, mesh))
    assert got == [(("a", "[0]"), (5,), ("data",)),
                   (("b",), (4, 32), ("data", "model"))]


def test_partition_spec_is_a_tuple():
    spec = P(("pod", "data"), None, "model")
    assert tuple(spec) == tuple(JP(("pod", "data"), None, "model"))
    assert spec == (("pod", "data"), None, "model")
    assert repr(spec) == "P(('pod', 'data'), None, 'model')"


# ------------------------------------------------------------ fake meshes --

class _Mesh:
    """A DeviceMesh of the ``"fake"`` backend (one process standing in for
    every rank), the default group destroyed on exit."""

    def __init__(self, multi_pod: bool):
        self.multi_pod = multi_pod

    def __enter__(self):
        world = 512 if self.multi_pod else 256
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        return make_production_mesh(multi_pod=self.multi_pod,
                                    device_type="cpu")

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fake_mesh_local_bytes_are_the_shard_arithmetic(mesh_name):
    with _Mesh(mesh_name == "multi_pod") as mesh:
        msd = mesh_shape_dict(mesh)
        assert msd == MESHES[mesh_name]
        assert mesh.mesh_dim_names == tuple(MESHES[mesh_name])
        for arch in ARCH_IDS:
            cfg = build_cfg(arch, msd)
            params = TS.params_shapes(cfg)
            specs = TPAR.param_specs(cfg, params, msd)
            dparams = TPAR.distribute_tree(params, specs, mesh)
            local, arith = [], []

            def count(keys, leaf, spec, dleaf):
                n = leaf.numel() * leaf.element_size()
                for ax in tuple(spec):
                    for a in () if ax is None else (
                            (ax,) if isinstance(ax, str) else ax):
                        n //= msd[a]
                arith.append(n)
                loc = dleaf.to_local()
                assert loc.device.type == "meta"
                local.append(loc.numel() * loc.element_size())

            tree_map_with_keys(count, params, specs, dparams)
            assert local == arith, arch
            assert sum(local) < 8e9, (arch, sum(local))


def test_placements_follow_the_mesh_order():
    with _Mesh(True) as mesh:
        assert TPAR.placements(P(("pod", "data"), None, "model"), mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert TPAR.placements(P(None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        assert TPAR.placements(P(), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            TPAR.placements(P(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="lacks"):
            TPAR.placements(P("expert"), mesh)
        # a (pod, data)-sharded batch: each rank keeps 256 / 32 rows
        t = torch.empty((256, 4096), device="meta")
        d = TPAR.distribute_tree({"tokens": t}, {"tokens": P(("pod", "data"))},
                                 mesh)["tokens"]
        assert tuple(d.to_local().shape) == (8, 4096)


def test_distribute_tree_wraps_without_copy_at_world_size_one(tmp_path):
    with W.one_rank_group(tmp_path):
        mesh = make_mesh({"data": 1, "model": 1}, "cpu")
        t = torch.arange(12.0).reshape(3, 4)
        tree = TPAR.distribute_tree({"w": t, "pos": 0},
                                    {"w": P(None, "model"), "pos": P()}, mesh)
        assert isinstance(tree["w"], DTensor) and tree["pos"] == 0
        assert tree["w"].placements == (Replicate(), Shard(1))
        assert tree["w"].to_local().data_ptr() == t.data_ptr()


# ---------------------------------------------------------------- devices --

def test_resolve_device_takes_meta_and_refuses_a_missing_card(monkeypatch):
    assert resolve_device("meta") == torch.device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("mps")


# ----------------------------------------------------------- collectives --

def test_int8_all_reduce_one_rank_error_bound(tmp_path):
    """``tests/test_distribution.py:81-92`` on a one-rank gloo group: the
    value comes back within one quantization step."""
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3.0, (1000,))
                         .astype(np.float32))
    with W.one_rank_group(tmp_path):
        out = int8_all_reduce(x, None)
    err = (out - x).abs().max().item()
    assert err <= x.abs().max().item() / 127.0 + 1e-6


@pytest.fixture(scope="module")
def gloo_dir(tmp_path_factory):
    """Where the four gloo ranks write their results."""
    return tmp_path_factory.mktemp("gloo")


@pytest.fixture(scope="module")
def gloo_results(gloo_dir):
    """Every check of ``torch_parallel_workers`` on four gloo ranks, spawned
    once; {check: [rank 0's numbers, ..., rank 3's]}."""
    d = gloo_dir
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, str(d / "init"), str(d)))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks {alive} did not finish"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(W.WORLD)]
    return {name: [r[name] for r in ranks] for name in W.CHECKS}


def _ok(results: list) -> list:
    for r in results:
        assert "error" not in r, r["error"]
    return results


def test_hierarchical_grad_reduce_multipod(gloo_results):
    """``tests/test_elastic.py:92-113``'s check: within scale / 64 of the
    mean over the four data-parallel shards with int8 across pods; the
    float mean of four values summed in another order within 1e-6."""
    for r in _ok(gloo_results["hierarchical"]):
        assert r["int8"] <= r["scale"] / 64, r
        assert r["float"] <= 1e-6, r


def test_int8_all_reduce_four_ranks_error_bound(gloo_results):
    """Each rank's value is within half its own step s_r of its int8
    mantissa, and each requantized mantissa within half the shared step
    S = sum s_r of it; summed over n ranks and divided by n, the mean is
    within (n + 1) S / (2 n) of the float mean, which is at most
    (n + 1) / 2 = 2.5 of the largest rank's steps, so within 4 steps."""
    n = W.WORLD
    results = _ok(gloo_results["int8"])
    for r in results:
        assert r == results[0]             # every rank holds the same mean
        for err, big, shared in zip(r["err_by_chunk"],
                                    r["max_step_by_chunk"],
                                    r["shared_step_by_chunk"]):
            assert err <= (n + 1) * shared / (2 * n) + 1e-6
            assert err <= 4 * big


def test_moe_expert_parallel_matches_plain(gloo_results):
    """Groups and experts over 'data' on four ranks: one expert a rank, the
    buffer moved to its experts and back; equal to plain ``apply_moe``
    within 1e-6 (``tests/test_layouts.py``'s bound)."""
    for r in _ok(gloo_results["moe"]):
        assert r["wi_spec"] == ["data"] and r["wi_local"] == [1, 8, 16]
        assert r["out"] <= 1e-6 and r["aux"] <= 1e-6, r


@pytest.mark.parametrize("experts", ["replicated_experts",
                                     "sharded_experts"])
def test_moe_groups_keep_the_batch_sharding_without_group_axis(
        gloo_results, experts):
    """No ``group_axis``, tokens over 'data' on four ranks: each rank
    dispatches its own group only, a quarter of the plain buffer's rows
    (4 experts x 1 group x capacity 32, not 4 x 4 x 32), and the result
    equals plain ``apply_moe`` within 1e-6."""
    for r in _ok(gloo_results["moe_batch"]):
        assert r["plain_buf"] == [4, 4 * 32, 8]
        got = r[experts]
        assert got["local_bufs"] == [[4, 32, 8]], got
        assert got["out"] <= 1e-6 and got["aux"] <= 1e-6, got


def test_olmo_sharded_train_step_matches_unsharded(gloo_results):
    """A two-microbatch step at a constant lr of 1e-3 on (data 2, model 2):
    losses and norms within 1e-5 relative, new weights within 1e-5 and
    both moments within 1e-5 of their largest value (the tolerance of the
    port's train step against the reference: float32 sums over a 64-wide
    model taken in another order, here across two ranks, move the last few
    bits of each gradient).  The
    step moves the weights by about the lr, 100 times the tolerance, so a
    wrong update shows.  New weights keep the parameters' layout, the
    ZeRO-1 moments theirs."""
    for r in _ok(gloo_results["olmo"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(*r[key], rtol=1e-5)
        assert r["update"] >= 5e-4, r["update"]
        assert r["params"]["err"] <= 1e-5 * max(1.0, r["params"]["scale"])
        for key in ("m", "v"):
            assert r[key]["err"] <= 1e-5 * r[key]["scale"], (key, r[key])
        assert r["kept_layout"] == {"params": True, "m": True, "v": True}


def test_olmo_sharded_prefill_and_decode_match_unsharded(gloo_results):
    """Last-position logits of the prefill (through the flash kernel's
    path) and of one decode step within 1e-5 (float32; the row-parallel
    products sum two ranks' partial sums, another order than one rank's);
    the KV cache lies as ``cache_specs`` puts it, batch over 'data' and kv
    heads over 'model'."""
    for r in _ok(gloo_results["olmo"]):
        assert r["prefill"] <= 1e-5 and r["decode"] <= 1e-5, r
        assert r["cache_global"] == [1, 4, 40, 4, 16]
        assert r["cache_local"] == [1, 2, 40, 2, 16]
        storage, shard = r["cache_storage"]     # allocated at its shard
        assert storage == shard == 1 * 2 * 40 * 2 * 16 * 4


def test_sharded_cache_is_allocated_at_its_shards(gloo_results):
    """A fresh cache on four ranks, batch over 'data': every leaf holds the
    plain cache's values (zeros, a ring buffer's slot positions -1), the
    batched leaves hold a quarter of the batch each, and each rank's
    storage is its shard's bytes; no tensor larger than the largest shard
    is made on the way, so no rank ever holds the whole cache."""
    for r in _ok(gloo_results["cache_alloc"]):
        assert "blocks/0/slot_pos" in r["mixtral-8x7b"]["keys"]
        assert "blocks/0/k_q" in r["qwen1.5-32b"]["keys"]
        assert "blocks/4/k" in r["jamba-1.5-large-398b"]["keys"]
        for arch, got in r.items():
            assert got["pos"] == 0 and got["values_equal"], arch
            assert got["batch_sharded"] == [
                k for k in got["keys"] if not k.endswith("slot_pos")], arch
            for key, (storage, shard) in got["storage"].items():
                assert storage == shard, (arch, key, storage, shard)
            assert got["largest_made"] == max(
                shard for _, shard in got["storage"].values()), arch


def test_mamba_sharded_prefill_matches_unsharded(gloo_results):
    """Smoke mamba2-1.3b on (data 1, model 2): each rank scans its four of
    the eight heads, and steps their recurrence in decode; logits within
    1e-5, the SSM state cache over heads."""
    results = _ok(gloo_results["mamba"])
    assert results[2] == results[3] == {}      # not in the mesh
    for r in results[:2]:
        assert r["prefill"] <= 1e-5 and r["decode"] <= 1e-5, r
        assert r["ssm_global"] == [1, 2, 8, 16, 16]
        assert r["ssm_local"] == [1, 2, 4, 16, 16]
        assert r["ssm_storage"] == [1 * 2 * 4 * 16 * 16 * 4] * 2


@pytest.mark.parametrize("layout", ["tp", "dp_tp"])
def test_mamba_sharded_train_step_matches_unsharded(gloo_results, layout):
    """One train step of smoke mamba2-1.3b, each rank taking the SSD's
    backward of its four of the eight heads under ``local_map``: on (data
    1, model 2) ("tp", ranks 0 and 1) and on (data 2, model 2) with the
    batch over 'data' ("dp_tp").  Loss and grad norm within 1e-5 relative
    and the new weights within 1e-5 of the unsharded step (the tolerance of
    the olmo step above); the step moves the weights by about the lr, so a
    lost share of a gradient shows (B/C, read by every head, and the conv
    weights, read by every batch row, take theirs from every rank)."""
    results = _ok([r[layout] for r in _ok(gloo_results["mamba_train"])])
    if layout == "tp":
        assert results[2] == results[3] == {}      # not in the mesh
        results = results[:2]
    for r in results:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(*r[key], rtol=1e-5)
        assert r["update"] >= 5e-4, r["update"]
        assert r["params"]["err"] <= 1e-5 * max(1.0, r["params"]["scale"])
        assert r["a_log_local"] == [1, 4]        # (repeats, local heads)


def test_gqa_heads_sharded_per_rank_match_unsharded(gloo_results):
    """Smoke yi-6b (GQA: 4 q heads over 2 kv heads) on (data 1, model 4):
    ``AttnDims(tp=4)`` duplicates the kv heads to 4, so each rank holds one
    q head and the one kv head it reads; prefill and decode logits within
    1e-5 of the unsharded port on the same weights."""
    for r in _ok(gloo_results["gqa"]):
        assert r["kv_global"] == [1, 2, 40, 4, 16]
        assert r["kv_local"] == [1, 2, 40, 1, 16]
        assert r["wq_local"] == [1, 64, 16]
        assert r["prefill"] <= 1e-5 and r["decode"] <= 1e-5, r


def test_olmo_microbatches_of_a_data_sharded_batch(gloo_results, gloo_dir):
    """Smoke olmo-1b on (data 4, model 1), a batch of 8 (two rows a rank)
    in two microbatches: each microbatch holds the reference's rows (the
    first four, then the last four), so the loss is the mean of their mean
    losses.  The labels' -1 positions differ by row, so the rows each rank
    would split locally ({0, 2, 4, 6} and {1, 3, 5, 7}) give another loss,
    more than ten times the tolerance away (at random weights every
    token's loss is near log V, so any grouping moves it little).  Loss and grad norm within 1e-5 relative of
    the unsharded port and of the reference's ``make_train_step`` with two
    microbatches on the same weights; the new weights within 1e-5 of both
    (the tolerance of the olmo step above), at AdamW's eps of
    ``W.MICROBATCH_OPT`` (see there why not the default)."""
    cfg, params, batch = W.olmo_microbatch_inputs()
    jc = j_smoke_config("olmo-1b", tp=1)
    jparams = jax.tree.unflatten(
        jax.tree.structure(JT.init_params(jc, jax.random.PRNGKey(0))),
        [jnp.asarray(t.numpy()) for t in tree_leaves(params)])
    jo = JAdamWConfig(lr=W.MICROBATCH_OPT.lr, eps=W.MICROBATCH_OPT.eps)
    jnew, _, jm = jax.jit(j_make_train_step(jc, jo, num_microbatches=2))(
        jparams, j_adamw_init(jparams, jo),
        {k: jnp.asarray(v) for k, v in batch.items()})
    local_rows = [0, 2, 4, 6, 1, 3, 5, 7]
    step = make_train_step(cfg, W.MICROBATCH_OPT, num_microbatches=2)
    _, _, wrong = step(params, adamw_init(params, W.MICROBATCH_OPT),
                       {k: torch.from_numpy(v[local_rows])
                        for k, v in batch.items()})
    assert abs(float(wrong["loss"]) / float(jm["loss"]) - 1) > 1e-4
    for r in _ok(gloo_results["olmo_microbatches"]):
        assert r["tokens_local"] == [2, 32]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(*r[key], rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(r[key][0], float(jm[key]), rtol=1e-5,
                                       err_msg=key)
        assert r["update"] >= 5e-4, r["update"]
        assert r["params"]["err"] <= 1e-5 * max(1.0, r["params"]["scale"])
    got = np.load(gloo_dir / "olmo_microbatches.npz")
    want = flatten(jax.tree.map(np.asarray, jnew))
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
