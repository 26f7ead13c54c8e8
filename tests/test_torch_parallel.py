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
  expert-parallel MoE equal to plain, sharded smoke olmo-1b (train
  step, prefill, decode) and mamba2-1.3b (prefill, decode and a train
  step) against the unsharded port, decode steps past the end of a full
  cache (float32 and int8) against the unsharded port, the sharded
  loss and its gradients against plain for a vocab-split, a d-split and an
  FSDP head, smoke qwen1.5-32b and mixtral-8x7b on (data 1, model 4)
  against the unsharded port, the shard-seeded weights
  (``models/shard_init.py``) against their whole tree, the judgement of
  MoE route changes, which refuses a moved router, and a bfloat16 train
  step of smoke yi-6b, minitron-8b and musicgen-large on (data 1, model 4)
  and (data 2, model 2) against the unsharded step, its collectives equal
  to the dry run's on a fake mesh of the same shape.  The checks and their
  tolerances live in ``repro_torch.launch.mesh_checks``, which
  ``chip_smoke.py --cards 4`` runs on four cards under NCCL and holds by
  ``mesh_checks.verdicts``; each test below holds its case of the gloo run
  by the same ``verdict``, beside its own structural asserts.
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
    _ok(gloo_results["hierarchical"])
    assert W.verdict("hierarchical", gloo_results["hierarchical"]) is None


def test_int8_all_reduce_four_ranks_error_bound(gloo_results):
    """Each rank's value is within half its own step s_r of its int8
    mantissa, and each requantized mantissa within half the shared step
    S = sum s_r of it; summed over n ranks and divided by n, the mean is
    within (n + 1) S / (2 n) of the float mean, which is at most
    (n + 1) / 2 = 2.5 of the largest rank's steps, so within 4 steps."""
    results = _ok(gloo_results["int8"])
    for r in results:
        assert r == results[0]             # every rank holds the same mean
    assert W.verdict("int8", results) is None


def test_moe_expert_parallel_matches_plain(gloo_results):
    """Groups and experts over 'data' on four ranks: one expert a rank, the
    buffer moved to its experts and back; equal to plain ``apply_moe``
    within 1e-6 (``tests/test_layouts.py``'s bound)."""
    for r in _ok(gloo_results["moe"]):
        assert r["wi_spec"] == ["data"] and r["wi_local"] == [1, 8, 16]
    assert W.verdict("moe", gloo_results["moe"]) is None


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
        assert r[experts]["local_bufs"] == [[4, 32, 8]], r[experts]
    assert W.verdict("moe_batch", gloo_results["moe_batch"], experts) is None


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
        assert r["kept_layout"] == {"params": True, "m": True, "v": True}
    assert W.verdict("olmo", gloo_results["olmo"], "train") is None


def test_olmo_sharded_prefill_and_decode_match_unsharded(gloo_results):
    """Last-position logits of the prefill (through the flash kernel's
    path) and of one decode step within 1e-5 (float32; the row-parallel
    products sum two ranks' partial sums, another order than one rank's);
    the KV cache lies as ``cache_specs`` puts it, batch over 'data' and kv
    heads over 'model'."""
    for r in _ok(gloo_results["olmo"]):
        assert r["cache_global"] == [1, 4, 40, 4, 16]
        assert r["cache_local"] == [1, 2, 40, 2, 16]
        storage, shard = r["cache_storage"]     # allocated at its shard
        assert storage == shard == 1 * 2 * 40 * 2 * 16 * 4
    assert W.verdict("olmo", gloo_results["olmo"], "serve") is None


@pytest.mark.parametrize("cache", ["float", "int8"])
def test_sharded_decode_past_the_cache_end_matches_unsharded(gloo_results,
                                                             cache):
    """Two decode steps past the end of a cache the prompt filled, on
    (data 2, model 2): the logits within 1e-5 of the unsharded port's (held
    to the reference in ``tests/test_torch_serve.py``), and the last slot
    rewritten by each step on the sharded path as on the plain one (int8
    codes equal)."""
    for r in _ok(gloo_results["decode_past_end"]):
        r = r[cache]
        assert r["last_slot"] == 0 and r["last_slot_written"], r
    assert W.verdict("decode_past_end", gloo_results["decode_past_end"],
                     cache) is None


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
    assert W.verdict("cache_alloc", gloo_results["cache_alloc"]) is None


def test_mamba_sharded_prefill_matches_unsharded(gloo_results):
    """Smoke mamba2-1.3b on (data 1, model 2): each rank scans its four of
    the eight heads, and steps their recurrence in decode; logits within
    1e-5, the SSM state cache over heads."""
    results = _ok(gloo_results["mamba"])
    assert results[2] == results[3] == {}      # not in the mesh
    for r in results[:2]:
        assert r["ssm_global"] == [1, 2, 8, 16, 16]
        assert r["ssm_local"] == [1, 2, 4, 16, 16]
        assert r["ssm_storage"] == [1 * 2 * 4 * 16 * 16 * 4] * 2
    assert W.verdict("mamba", results) is None


@pytest.mark.parametrize("layout", ["tp", "dp_tp"])
def test_mamba_sharded_train_step_matches_unsharded(gloo_results, layout):
    """One train step of smoke mamba2-1.3b, each rank taking the SSD's
    backward of its four of the eight heads under ``local_map``: on (data
    1, model 2) ("tp", ranks 0 and 1) and on (data 2, model 2) with the
    batch over 'data' ("dp_tp").  Loss and grad norm within 1e-5 relative
    and the new weights within 1e-5 of the unsharded step, each leaf's
    moments within 1e-5 of their largest value (``mesh_checks._step_ok``,
    the tolerance of the olmo step above); the step moves the weights by about the lr, so a
    lost share of a gradient shows (B/C, read by every head, and the conv
    weights, read by every batch row, take theirs from every rank)."""
    results = _ok([r[layout] for r in _ok(gloo_results["mamba_train"])])
    if layout == "tp":
        assert results[2] == results[3] == {}      # not in the mesh
        results = results[:2]
    for r in results:
        assert r["a_log_local"] == [1, 4]        # (repeats, local heads)
    assert W.verdict("mamba_train", gloo_results["mamba_train"],
                     layout) is None


def test_jamba_fsdp_train_step_matches_unsharded(gloo_results):
    """Smoke jamba with its FSDP layout on (pod 2, data 2, model 1), two
    rows (the input batch split over 'pod' alone, the hidden stream over
    both batch axes): each layer's FSDP weights gathered over
    'data' at its entry (``shards.gather_fsdp``), one train step against the
    unsharded step on the same weights, at the olmo and mamba steps'
    tolerances (loss and grad norm 1e-5 relative, weights 1e-5, each
    leaf's moments 1e-5 of their largest value)."""
    _ok(gloo_results["jamba_fsdp_train"])
    assert W.verdict("jamba_fsdp_train",
                     gloo_results["jamba_fsdp_train"]) is None


@pytest.mark.parametrize("case", sorted(W.DP_CASES))
def test_dp_layout_train_step_matches_unsharded(gloo_results, case):
    """The reference's ``layout="dp"`` (the opt layout of olmo-1b and
    mamba2-1.3b): parameters replicated, ZeRO-1 moments over ('data',
    'model'), four rows over every mesh dim, on (data 2, model 2) and on
    (pod 2, data 2, model 1).  Each gradient is reduced once into its
    moments' shard (``shards.relayout``) and the norm is a sum over shards
    and one all-reduce, so its float32 sums run in another order than the
    unsharded step's: one step against that step at the olmo step's
    tolerances (loss and grad norm 1e-5 relative, weights 1e-5, each leaf's
    moments 1e-5 of their largest value); the step
    moves the weights by about the lr, so a gradient reduced twice or not
    at all shows."""
    _ok([r[case] for r in _ok(gloo_results["dp_train"])])
    assert W.verdict("dp_train", gloo_results["dp_train"], case) is None


def _uneven_results(gloo_results, case: str) -> list:
    if case == "jamba":
        return _ok(gloo_results["jamba_fsdp_train"])
    return [r[case] for r in _ok(gloo_results["uneven_pin"])]


@pytest.mark.parametrize("case", ["olmo", "moe", "jamba"])
def test_uneven_pinned_rows_train_step_matches_unsharded(gloo_results,
                                                         case):
    """Microbatches of two rows on (pod 2, data 2, model 1), ``batch_axes``
    pod and data: smoke olmo-1b and smoke qwen2-moe with four dispatch
    groups (four rows in two microbatches), and smoke jamba (MoE, Mamba,
    FSDP; one microbatch of two).  The hidden stream is pinned over both
    batch axes, one row on the ranks of 'data' 0 and none on those of
    'data' 1, as ``torch.chunk`` splits two rows over four ranks; one
    train step against the unsharded step on the same weights (loss and
    grad norm 1e-5 relative, weights 1e-5, each leaf's moments 1e-5 of
    their largest value)."""
    for rank, r in enumerate(_uneven_results(gloo_results, case)):
        assert r["pinned_rows"] == [1 - rank % 2], (rank, r["pinned_rows"])
    if case == "jamba":
        assert W.verdict("jamba_fsdp_train",
                         gloo_results["jamba_fsdp_train"]) is None
    else:
        assert W.verdict("uneven_pin", gloo_results["uneven_pin"],
                         case) is None


def test_merge_and_split_rows_of_an_uneven_batch(gloo_results):
    """``shards.merge_rows`` on two rows of 8 over (pod 2, data 2) (1, 0,
    1, 0 by rank): the 16 merged rows 4 a rank, equal to the plain
    reshape; ``split_rows`` of them back in the input's layout; the
    gradient through the exchange equal to plain autograd's (exact: the
    rows only move)."""
    for rank, r in enumerate(_ok(gloo_results["uneven_pin"])):
        r = r["rows"]
        assert r["rows_local"] == 4 and r["back_local"] == 1 - rank % 2
    assert W.verdict("uneven_pin", gloo_results["uneven_pin"], "rows") is None


@pytest.mark.parametrize("head", sorted(W.LOSS_HEADS))
def test_sharded_loss_matches_plain_for_each_head(gloo_results, head):
    """``chunked_cross_entropy`` on (data 2, model 2), the rows over 'data',
    against plain on the same inputs, for a head split over the vocab (each
    rank's 256 columns combined by ``shards.nll_sum``), one split on d
    (vocab 511) and an FSDP head: the loss within 1e-5 relative, the
    gradients of the hidden state, the head and the final norm's scale
    within 1e-5 of their largest value (the train steps' tolerance).
    Labels -1, on each vocab shard's first and last column, and a chunk
    all masked."""
    for r in _ok(gloo_results["loss_heads"]):
        assert r[head]["head_local"] == {"vocab": [16, 256], "d": [8, 511],
                                         "fsdp": [8, 256]}[head]
    assert W.verdict("loss_heads", gloo_results["loss_heads"], head) is None


def test_gqa_heads_sharded_per_rank_match_unsharded(gloo_results):
    """Smoke yi-6b (GQA: 4 q heads over 2 kv heads) on (data 1, model 4):
    ``AttnDims(tp=4)`` duplicates the kv heads to 4, so each rank holds one
    q head and the one kv head it reads; prefill and decode logits within
    1e-5 of the unsharded port on the same weights."""
    for r in _ok(gloo_results["gqa"]):
        assert r["kv_global"] == [1, 2, 40, 4, 16]
        assert r["kv_local"] == [1, 2, 40, 1, 16]
        assert r["wq_local"] == [1, 64, 16]
    assert W.verdict("gqa", gloo_results["gqa"]) is None


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
    assert W.verdict("olmo_microbatches",
                     gloo_results["olmo_microbatches"]) is None
    got = np.load(gloo_dir / "olmo_microbatches.npz")
    want = flatten(jax.tree.map(np.asarray, jnew))
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", sorted(W.MESH4_SERVE))
def test_mesh4_smoke_serving_matches_unsharded(gloo_results, arch):
    """Smoke qwen1.5-32b (MHA, QKV bias, the int8 KV cache) and smoke
    mixtral-8x7b (GQA, a window of 16 under a 40-token prompt, so its ring
    cache wraps; the MoE top-2) on (data 1, model 4), the production
    cells' mesh: one kv head a rank; the prefill through the flash
    kernel's path and four greedy decode steps within 1e-5 of the
    unsharded port on the same tp-4 weights (float32; the row-parallel
    products sum four ranks' partial sums)."""
    for r in _ok(gloo_results["mesh4_serve"]):
        r = r[arch]
        assert r["kv_local"][3] == 1 and r["kv_global"][3] == W.WORLD, r
        assert r["pos"] == 40 + W.MESH4_DECODE_STEPS
        assert r["ring"] == (arch == "mixtral-8x7b")
        if arch == "mixtral-8x7b":      # the ring holds the window only
            assert r["kv_global"][2] == 16
    assert W.verdict("mesh4_serve", gloo_results["mesh4_serve"], arch) is None


@pytest.mark.parametrize("arch", sorted(W.SHARD_INIT))
def test_shard_init_shards_are_slices_of_the_whole_tree(gloo_results, arch):
    """``init_shards`` on (data 1, model 4): every leaf's shard on every
    rank equals its slice of ``init_whole``'s tree bit for bit (and the
    gathered tree the whole one), so one card can make the whole of a
    2-layer model that four cards hold in shards; the sharded tree's
    prefill and decode within 1e-5 of the unsharded port on the whole
    tree."""
    for r in _ok(gloo_results["shard_init"]):
        r = r[arch]
        assert r["sliced_equal"] and r["gathered_equal"], r
        assert r["wq_local"][2] * W.WORLD == (8 if arch == "mixtral-8x7b"
                                              else 4) * 16
    assert W.verdict("shard_init", gloo_results["shard_init"], arch) is None


def test_shard_init_refuses_duplicated_heads():
    """Smoke mixtral-8x7b at tp 4 duplicates its two kv heads: a drawn
    block of a copy would not equal its original, so the scheme refuses."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import shard_init as SI
    with pytest.raises(ValueError, match="duplicates"):
        SI.init_whole(smoke_config("mixtral-8x7b", tp=4),
                      {"data": 1, "model": 4}, 0, device="cpu")


TRAIN_CASES = [f"{a} {m}" for a in W.TRAIN_CELLS for m in W.TRAIN_MESHES]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_cell_bf16_step_matches_unsharded(gloo_results, case):
    """A bfloat16 step (two microbatches, the reference's AdamW config,
    moments at ``opt_dtype``) of the four-card train cells' archs at smoke
    size, their weights drawn shard by shard, ZeRO-1 moments over 'data',
    against the unsharded step on the same weights: within
    ``mesh_checks.BF16_STEP_TOL``, the tolerances
    ``tests/test_torch_bf16_train.py`` argues for the port's step against
    the reference's (loss 5e-4 relative, grad norm 4e-3 a layer, every
    weight within 2 lr plus a bfloat16 step of its leaf, under 0.5% of
    them past 0.5 lr plus a step of their own value, each leaf's moments
    within 0.08 relative L2); every leaf keeps its layout, and each rank
    holds its share of the batch's rows."""
    arch, mesh = case.split()
    data = W.TRAIN_MESHES[mesh]["data"]
    for r in _ok(gloo_results["train_cells"]):
        c = r[case]
        assert c["kept_layout"] and c["layers"] == 2
        assert c["tokens_local"][:2] == [W.TRAIN_CELL_ROWS // data,
                                         W.TRAIN_CELL_SEQ]
        assert len(c["loss"]) == W.TRAIN_CELL_STEPS
        assert c["update"] >= 0.5 * c["lr"]
    assert W.verdict("train_cells", gloo_results["train_cells"], case) is None


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_cell_collectives_equal_the_dry_runs(gloo_results, case):
    """Each gloo rank's collectives in the train cell's step
    (``commcount.CollectiveCounter``), by kind, count and result bytes,
    equal the dry run's count of the same smoke cell
    (``dryrun._trace_cell`` under the same counter) on a fake mesh of that
    shape, the cuda-typed one the dry run lays out on: each gradient
    reduced once, the batch and the new weights gathered where 'data'
    splits them, and nothing per microbatch that the dry run does not
    count."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.cell_memory import fake_mesh
    from repro_torch.launch.commcount import CollectiveCounter
    from repro_torch.launch.dryrun import _trace_cell
    arch, mesh = case.split()
    shape = W.TRAIN_MESHES[mesh]
    cfg = W.train_cell_cfg(arch, shape)
    cell = ShapeCell("small", "train", W.TRAIN_CELL_SEQ, W.TRAIN_CELL_ROWS)
    with fake_mesh(shape) as fake:
        fn, args = _trace_cell(cfg, cell, fake,
                               microbatches=W.TRAIN_CELL_MICROBATCHES)
        with CollectiveCounter() as counter:
            fn(*args)
    want = counter.result()
    assert want["counts"]["all-reduce"] > 0
    for r in _ok(gloo_results["train_cells"]):
        got = r[case]["collectives"]
        assert got["counts"] == want["counts"]
        assert got["looped"] == want["looped"]


def test_card_verdicts_agree_with_these_tests(gloo_results):
    """``mesh_checks.verdicts``, by which ``chip_smoke.py --cards 4`` holds
    the NCCL run and the tests above the gloo run, passes every check of
    the gloo run and refuses a result moved past a tolerance or off its
    shape, each in its own check, rank and case alone."""
    assert W.verdicts(gloo_results) == {k: None for k in W.CHECKS}
    worse = json.loads(json.dumps(gloo_results))
    worse["olmo"][1]["prefill"] = 2e-5
    worse["shard_init"][2]["qwen1.5-32b"]["sliced_equal"] = False
    worse["shard_init"][3]["mixtral-8x7b"]["wq_local"][2] *= 2
    worse["mesh4_serve"][0]["mixtral-8x7b"]["kv_global"][2] = 40
    # the largest moment 2e-5 of its value off; a quarter of the smallest
    # leaf's gradient lost (a_log's, 1e-3 of the largest)
    moments = worse["dp_train"][1]["mamba"]["moments"]
    big = max(moments, key=lambda k: moments[k][1])
    moments[big][0] = 2e-5 * moments[big][1]
    moments = worse["mamba_train"][2]["dp_tp"]["moments"]
    small = min(moments, key=lambda k: moments[k][1] or float("inf"))
    moments[small][0] = 0.25 * moments[small][1]
    # a bfloat16 train cell: one weight 3 lr past its bound, and one leaf's
    # first moment 10% off in L2 (as a tenth of its gradient lost)
    cell = worse["train_cells"][3]["yi-6b dp2_tp2"]
    leaf = next(iter(cell["weights"]["leaves"]))
    cell["weights"]["leaves"][leaf][0] += (
        2 * W.TRAIN_CELL_STEPS + 3) * cell["lr"]
    cell = worse["train_cells"][1]["musicgen-large tp4"]
    moments = cell["moments"]
    big = max(moments, key=lambda k: moments[k][5])
    moments[big][4] = 0.1 ** 2 * moments[big][5]
    got = W.verdicts(worse)
    assert set(got["olmo"]) == {1} and set(got["shard_init"]) == {2, 3}
    assert set(got["mesh4_serve"]) == {0} and set(got["dp_train"]) == {1}
    assert set(got["mamba_train"]) == {2}
    assert set(got["train_cells"]) == {1, 3}
    assert [k for k, v in got.items() if v] == [
        "olmo", "mamba_train", "dp_train", "mesh4_serve", "shard_init",
        "train_cells"]
    assert W.verdict("train_cells", worse["train_cells"],
                     "minitron-8b tp4") is None
    assert W.verdict("olmo", worse["olmo"], "train") is None
    assert W.verdict("mesh4_serve", worse["mesh4_serve"],
                     "qwen1.5-32b") is None
    assert W.verdict("dp_train", worse["dp_train"], "olmo") is None


def test_route_excuse_refuses_a_moved_router(gloo_results):
    """Smoke mixtral-8x7b on (data 1, model 4): every compared row of the
    sharded port (the prefill's last token, four decode steps) holds
    against the unsharded port with no route changed; with the sharded
    copy's routers moved by N(0, 1) times their scale, rows past the
    tolerance whose own routes changed are refused (``judge_rows``), since
    the changes lie far past a near tie: a perturbed MoE weight is not
    excused by the routes it moves."""
    for r in _ok(gloo_results["route_excuse"]):
        assert r["same"]["expert_slots"] == r["same"]["keep_slots"] == 0
        assert all(v == "held" for call in r["same"]["judged"]
                   for v in call), r["same"]
        moved = r["moved"]
        assert moved["expert_slots"] > 0
        assert any(rows for rows in moved["changed_rows"])
        assert all(not m["near_tie"] and min(m["margins"]) > m["tol"]
                   for m in moved["margins"]), moved["margins"]
        assert "excused" not in {v for call in moved["judged"]
                                 for v in call}
    assert W.verdict("route_excuse", gloo_results["route_excuse"]) is None


def _routes(experts: list, keep: list, logits=None) -> tuple:
    """One recorded MoE call of one group (``RouteRecorder`` layout)."""
    rec = (torch.tensor([experts]), torch.tensor([keep]))
    return rec if logits is None else rec + (torch.tensor(logits),)


@pytest.mark.parametrize("case", ["near_tie", "far", "keep_only", "none"])
def test_route_changes_excuse_only_a_near_tie(case):
    """Two rows of two tokens, top-1 of three experts, one layer: the
    second row's last token takes expert 1 in the reference and, in the
    other run, expert 2 (its router logits 0.02 apart), or expert 0 (0.5
    apart), or expert 1 with its capacity keep alone changed, or nothing
    changes.  Past the tolerance, that row is excused only for the
    change within the margin's tolerance (0.05); the first row, unchanged
    and past it, fails; rows within it hold."""
    from repro_torch.launch.mesh_checks import judge_rows, route_changes
    logits = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
              [0.1, 0.6, 0.58]]
    want = _routes([2, 1, 0, 1], [True] * 4, logits)
    got_e, got_k = {"near_tie": ([2, 1, 0, 2], [True] * 4),
                    "far": ([2, 1, 0, 0], [True] * 4),
                    "keep_only": ([2, 1, 0, 1], [True, True, True, False]),
                    "none": ([2, 1, 0, 1], [True] * 4)}[case]
    changes = route_changes([_routes(got_e, got_k)], [want], [2], 1, 1,
                            lambda layer, lg: 0.05)
    rows = changes[0]["rows"]
    if case == "none":
        assert rows == []
    else:
        assert [c["row"] for c in rows] == [1]
        assert rows[0]["keep_only"] == (case == "keep_only")
        assert rows[0]["near_tie"] == (case == "near_tie")
    assert changes[0]["expert_slots"] == int(case in ("near_tie", "far"))
    assert changes[0]["keep_slots"] == int(case == "keep_only")
    got = judge_rows([0.5, 0.5], 0.1, changes[0])
    assert got == ["failed", "excused" if case == "near_tie" else "failed"]
    assert judge_rows([0.01, 0.01], 0.1, changes[0]) == ["held", "held"]
