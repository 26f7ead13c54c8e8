"""The port's dry run (``launch/dryrun.py``), its collective counter
(``launch/commcount.py``) and the meta path they trace.

* The counterparts of ``tests/test_hloparse.py``: a result buffer's bytes
  by dtype; one all-reduce outside a loop counted once, and inside a
  Python loop of n trips n times (an eager loop issues it every trip); an
  all-to-all on a cuda-typed fake mesh counted as one (a cpu-typed mesh
  would turn it into an all-gather); the ``c10d`` ops of
  ``torch.distributed`` counted too.
* A sharded product counts the local 2 m n k FLOPs exactly, not the global
  product DTensor propagates its sharding through.
* The SSD scan on meta tensors (``ssd_scan_cuda`` and ``SsdScan``'s
  backward) gives the CPU path's shapes and dtypes and launches nothing; a
  smoke mamba2 train step's FLOPs hold its layers' SSD count (forward
  4 P N, backward ``flops_per_token_head`` a (token, head)); a sharded
  cache on meta is allocated at its shards; a smoke MoE train step
  traces where DTensor spreads the MoE's rows over more ranks than the
  batch's rows divide.
* Production cells on the 256/512-rank fake meshes: olmo-1b decode_32k,
  qwen2-moe-a2.7b decode_32k (multi-pod), mamba2-1.3b prefill_32k and
  olmo-1b train_4k with its production two microbatches over the 16-rank
  'data' axis.  Each one's ``argument_bytes`` is the shard arithmetic of
  the reference's specs over ``jax.eval_shape``
  (``tests/test_distribution.py:58-78``).
* The loss at its shard: smoke olmo-1b's ``chunked_cross_entropy`` on a
  fake 8-rank mesh makes no tensor of more rows than the device's share,
  nor, with the head split over the vocab, of the whole vocab; one
  olmo-1b train_4k layer's peak stays below six float32 copies of the
  device's parameter shards.
* Every arch's long_500k record: the reference's skip record, word for
  word, where the reference skips it.  ``repro.launch.dryrun`` is not
  imported (it sets ``XLA_FLAGS`` to 512 host devices when imported); its
  skip text is read from its source.
"""
import ast
import dataclasses
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import repro.parallel as JPAR
from repro.configs import SHAPES as J_SHAPES
from repro.configs import cell_applicable as j_cell_applicable
from repro.launch import specs as JS
from repro.launch.optconfig import build_cfg as j_build_cfg
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, \
    smoke_config
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch.commcount import (COLLECTIVE_KINDS,
                                          CollectiveCounter, result_bytes)
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.optconfig import build_cfg
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import batch_specs, distribute_tree, param_specs
from repro_torch.parallel.collectives import int8_all_reduce
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- counting --

def test_result_bytes_by_dtype():
    """``hloparse._buffer_bytes``'s cases: f32[4,8], (bf16[2,2], s8[4]) and
    a scalar pred."""
    assert result_bytes(_meta(4, 8)) == 128
    assert result_bytes((_meta(2, 2, dtype=torch.bfloat16),
                         _meta(4, dtype=torch.int8))) == 12
    assert result_bytes(_meta(dtype=torch.bool)) == 1


def test_all_reduce_outside_a_loop_counted_once():
    with dryrun.fake_world(4):
        mesh = make_mesh({"data": 4}, "cuda")
        with CollectiveCounter() as cc:
            funcol.all_reduce(_meta(128), "sum", mesh)
    res = cc.result()
    assert res["counts"] == {**{k: 0 for k in COLLECTIVE_KINDS},
                             "all-reduce": 1}
    assert res["looped"]["all-reduce"] == res["raw"]["all-reduce"] == 128 * 4
    assert res["looped"]["total"] == 128 * 4


def test_all_reduce_inside_a_loop_counted_every_trip():
    trips = 7
    with dryrun.fake_world(4):
        mesh = make_mesh({"data": 4}, "cuda")
        with CollectiveCounter() as cc:
            x = _meta(64)
            for _ in range(trips):
                x = funcol.all_reduce(x, "sum", mesh) * 0.5
    res = cc.result()
    assert res["counts"]["all-reduce"] == trips
    assert res["looped"]["all-reduce"] == trips * 64 * 4
    assert res["raw"] == res["looped"]


def test_all_to_all_on_a_cuda_typed_fake_mesh():
    """Shard(0) -> Shard(1) is one all-to-all of the local (16, 64) shard's
    4096 bytes, not an all-gather."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        x = distribute_tensor(_meta(256, 64), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        with CollectiveCounter() as cc:
            x.redistribute(mesh, [Shard(1), Replicate()])
    res = cc.result()
    assert res["counts"]["all-to-all"] == 1
    assert res["counts"]["all-gather"] == 0
    assert res["looped"]["all-to-all"] == 16 * 64 * 4


def test_torch_distributed_calls_are_counted():
    """``int8_all_reduce`` (``parallel/collectives.py``) issues two
    ``c10d`` all-reduces: the scales and the int32 mantissas."""
    with dryrun.fake_world(4):
        with CollectiveCounter() as cc:
            int8_all_reduce(_meta(1000), None)
    res = cc.result()
    assert res["counts"]["all-reduce"] == 2
    assert res["looped"]["all-reduce"] == 4 * 4 + 4 * 4 * 256


def test_sharded_product_counts_the_local_flops():
    """A (4096, 4096) product with rows over 'data' and columns over
    'model': each device multiplies (256, 4096) by (4096, 256).  DTensor
    also runs the product at its global shape to propagate the sharding;
    that would count 4096 times more."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        a = distribute_tensor(_meta(4096, 4096), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(_meta(4096, 4096), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with dryrun._CellCost((a, b)) as cost:
            out = a @ b
    assert tuple(out.to_local().shape) == (256, 256)
    assert cost.flops == 2 * 256 * 4096 * 256
    assert cost.bytes_accessed == 4 * (2 * 256 * 4096 + 256 * 256)
    assert cost.peak == 4 * 256 * 256


# ------------------------------------------------------------ meta path --

def _ssd_inputs(rng, dtype, b=2, s=80, h=4, g=2, p=16, n=8):
    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return (normal(b, s, h, p).to(dtype),
            torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h)).astype(
                np.float32)),
            torch.from_numpy(rng.uniform(-1, 1, h).astype(np.float32)),
            normal(b, s, g, n).to(dtype), normal(b, s, g, n).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("final_state", [False, True])
def test_ssd_scan_on_meta_gives_the_cpu_shapes(dtype, final_state):
    cpu = _ssd_inputs(np.random.default_rng(0), dtype)
    meta = tuple(t.to("meta") for t in cpu)
    ss.reset_launches()
    ss.reset_meta_flops()
    want = ss.ssd_scan_cuda(*cpu, chunk=32, final_state=final_state)
    got = ss.ssd_scan_cuda(*meta, chunk=32, final_state=final_state)
    want, got = (tuple(o) if final_state else (o,) for o in (want, got))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert ss.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    assert ss.META_FLOPS["ssd_scan"] == ss.forward_flops(2, 80, 4, 16, 8)
    assert ss.META_FLOPS["ssd_scan"] == 4 * 16 * 8 * 2 * 80 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_on_meta_gives_the_cpu_shapes(dtype):
    """Through ``SsdScan``: the five gradients of a meta call have the CPU
    path's shapes and dtypes (the backward gives float32, which autograd
    casts to each input's dtype, as it does the card's), and nothing is
    launched."""
    cpu = [t.requires_grad_() for t in _ssd_inputs(
        np.random.default_rng(1), dtype)]
    meta = [t.detach().to("meta").requires_grad_() for t in cpu]
    ss.reset_launches()
    ss.reset_meta_flops()
    grads = {}
    for name, ins in (("cpu", cpu), ("meta", meta)):
        y, state = ss.ssd_scan_cuda(*ins, chunk=32, final_state=True)
        grads[name] = torch.autograd.grad((y.float().sum()
                                           + state.sum()), ins)
    assert [(tuple(g.shape), g.dtype) for g in grads["meta"]] == \
        [(tuple(g.shape), g.dtype) for g in grads["cpu"]]
    assert all(g.device.type == "meta" for g in grads["meta"])
    assert ss.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    assert ss.META_FLOPS["ssd_scan_bwd"] == ss.backward_flops(2, 80, 4, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.ssd_scan_bwd_cuda(*meta, _meta(2, 80, 4, 16))


def test_ssd_flop_counts():
    assert ss.flops_per_token_head(4096, 64, 128) == (11.0625 * 64 * 128, 8)
    assert ss.backward_flops(1, 4096, 1, 64, 128) == 11.0625 * 64 * 128 * 4096


def test_sharded_cache_on_meta_is_allocated_at_its_shards():
    """jamba (attention and Mamba layers) on a cuda-typed fake mesh (data 4,
    model 1), batch over 'data': every leaf a DTensor whose local tensor is
    a meta tensor of its shard's shape and storage; a CPU cache on that
    mesh is refused."""
    cfg = smoke_config("jamba-1.5-large-398b", batch_axes=("data",))
    with dryrun.fake_world(4):
        mesh = make_mesh({"data": 4, "model": 1}, "cuda")
        cache = T.init_cache(cfg, 8, 40, device="meta", mesh=mesh)
        plain = T.init_cache(cfg, 8, 40, device="meta")
        with pytest.raises(ValueError, match="cpu cache on a cuda mesh"):
            T.init_cache(cfg, 8, 40, device="cpu", mesh=mesh)
    assert cache["pos"] == 0
    n = 0
    for sharded, whole in zip(cache["blocks"], plain["blocks"]):
        assert sharded.keys() == whole.keys()
        for key, t in sharded.items():
            loc = t.to_local()
            assert loc.device.type == "meta" and t.shape == whole[key].shape
            assert loc.shape[0] == whole[key].shape[0]
            assert loc.shape[1] * 4 == whole[key].shape[1], key
            assert loc.untyped_storage().nbytes() == \
                loc.numel() * loc.element_size()
            n += 1
    assert n >= 5


def test_smoke_mamba_train_step_counts_its_ssd_flops():
    """A smoke mamba2 train step on meta DTensors (data 2, model 2), batch
    over 'data': each layer's SSD runs on (2 rows, 4 of 8 heads) a device,
    forward once (twice with remat: remat recomputes it) and backward
    once, and the step's FLOPs are the products' plus those."""
    cfg = smoke_config("mamba2-1.3b", tp=2, batch_axes=("data",))
    with dryrun.fake_world(4):
        mesh = make_mesh({"data": 2, "model": 2}, "cuda")
        msd = {"data": 2, "model": 2}
        params = T.init_params(cfg, device="meta")
        dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                  mesh)
        opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
        batch = {"tokens": _meta(4, 64, dtype=torch.int32),
                 "labels": _meta(4, 64, dtype=torch.int32)}
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
        dopt = adamw_init(dparams, opt)
        ss.reset_meta_flops()
        with dryrun._CellCost((dparams, dopt, dbatch)) as cost:
            make_train_step(cfg, opt)(dparams, dopt, dbatch)
    ssm = cfg.ssm
    h = ssm.d_inner // ssm.head_dim
    local = (2, 64, h // 2, ssm.head_dim, ssm.d_state)
    layers = cfg.n_layers
    fwd = layers * (2 if cfg.remat else 1) * ss.forward_flops(*local)
    assert ss.META_FLOPS["ssd_scan"] == fwd
    assert ss.META_FLOPS["ssd_scan_bwd"] == layers * ss.backward_flops(*local)
    assert cost.flops > 0 and ss.LAUNCHES["ssd_scan"] == 0


# ------------------------------------------------------ production cells --

def _shard_bytes(tree, specs, mesh: dict) -> int:
    """``tests/test_distribution.py:58-78``: each leaf's bytes divided by
    the sizes of the mesh axes its spec names."""
    total = 0
    for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))):
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for ax in tuple(s):
            if ax is None:
                continue
            for a in (ax,) if isinstance(ax, str) else ax:
                n //= mesh[a]
        total += n
    return total


def _reference_argument_bytes(arch: str, shape: str, mesh_name: str) -> int:
    """The shard arithmetic of the reference's arguments of the cell: the
    parameters, and the ZeRO-1 moments and batch (train), the batch
    (prefill) or the batch and cache (decode).  The cache's position is
    left out: the reference holds it as an int32 scalar on the device, the
    port as a Python int on the host."""
    mesh = MESHES[mesh_name]
    cell = J_SHAPES[shape]
    jc = j_build_cfg(arch, mesh, kind=cell.kind)
    p = JS.params_shapes(jc)
    ps = JPAR.param_specs(jc, p, mesh)
    total = _shard_bytes(p, ps, mesh)
    if cell.kind == "train":
        o = JS.opt_shapes(jc, JAdamWConfig(moment_dtype=jc.opt_dtype), p)
        axes = ("data", "model") if jc.layout in ("dp", "fsdp2d") \
            else ("data",)
        zs = JPAR.zero1_specs(ps, p, mesh, axes=axes)
        total += _shard_bytes(o, {"m": zs, "v": zs, "step": JP()}, mesh)
        b = JS.train_input_specs(jc, cell)
    elif cell.kind == "prefill":
        b = JS.prefill_input_specs(jc, cell)
    else:
        b = JS.decode_input_specs(jc, cell)
        c = dict(JS.cache_shapes(jc, cell))
        c.pop("pos")
        total += _shard_bytes(c, JPAR.cache_specs(jc, c, mesh), mesh)
    return total + _shard_bytes(b, JPAR.batch_specs(jc, b, mesh), mesh)


@pytest.mark.parametrize("arch,shape,mesh_name", [
    ("olmo-1b", "decode_32k", "single_pod"),
    ("qwen2-moe-a2.7b", "decode_32k", "multi_pod"),
    ("mamba2-1.3b", "prefill_32k", "single_pod"),
    ("olmo-1b", "train_4k", "single_pod"),
])
def test_production_cell_traces(arch, shape, mesh_name):
    ss.reset_launches()
    rec = dryrun.run_cell(arch, shape, multi_pod=mesh_name == "multi_pod",
                          verbose=False)
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["mesh"] == mesh_name
    assert rec["n_devices"] == (512 if mesh_name == "multi_pod" else 256)
    mem = rec["memory"]
    assert mem["argument_bytes"] == _reference_argument_bytes(arch, shape,
                                                              mesh_name)
    assert mem["output_bytes"] > 0 and mem["temp_bytes"] > 0
    assert rec["flops_per_device"] > 0
    assert rec["bytes_accessed_per_device"] > 0
    coll = rec["collective_bytes_per_device"]
    assert coll == rec["collective_bytes_raw"]
    assert coll["total"] == sum(coll[k] for k in COLLECTIVE_KINDS) > 0
    assert set(rec["collective_counts"]) == set(COLLECTIVE_KINDS)
    assert ss.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    if shape == "train_4k":
        assert rec["microbatches"] == 2
        assert rec["collective_counts"]["reduce-scatter"] > 0
    if arch == "mamba2-1.3b":
        # 48 layers, each a device's (2 rows, 4 of 64 heads) of 32768
        # tokens through the SSD forward, P = 64, N = 128
        ssd = 48 * ss.forward_flops(2, 32768, 4, 64, 128)
        assert ss.META_FLOPS["ssd_scan"] == ssd
        assert rec["flops_per_device"] > ssd


def _reference_skip_reason() -> str:
    """The reason text of the skip record in ``src/repro/launch/
    dryrun.py`` (the dict with ``"status": "skipped"``), read from its
    source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            items = {k.value: v for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant)}
            status = items.get("status")
            if isinstance(status, ast.Constant) \
                    and status.value == "skipped":
                return ast.literal_eval(items["reason"])
    raise AssertionError("no skip record in the reference's dry run")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_long_500k_skip_records_are_the_reference(mesh_name):
    reason = _reference_skip_reason()
    skipped = 0
    for arch in ARCH_IDS:
        jc = j_build_cfg(arch, MESHES[mesh_name], kind="decode")
        if j_cell_applicable(jc, J_SHAPES["long_500k"]):
            assert cell_applicable(build_cfg(arch, MESHES[mesh_name],
                                             kind="decode"),
                                   SHAPES["long_500k"])
            continue
        rec = dryrun.run_cell(arch, "long_500k",
                              multi_pod=mesh_name == "multi_pod",
                              verbose=False)
        assert rec == {"arch": arch, "shape": "long_500k",
                       "mesh": mesh_name, "status": "skipped",
                       "reason": reason}
        skipped += 1
    assert skipped > 0


def test_moe_rows_keep_the_batch_layout():
    """A smoke qwen2-moe train step (one layer, no remat) on meta DTensors
    over (data 2, model 2), two rows over 'data': DTensor lays the MoE's
    B·S rows (and their gradient) out over both mesh dims, one row over
    two ranks, which no (B, S) split can follow; ``_ffn`` pins them to the
    batch's layout on both sides of the MoE.  The same fault stopped
    qwen2-moe-a2.7b train_4k on the 512-rank mesh (256 rows over 512
    ranks)."""
    cfg = smoke_config("qwen2-moe-a2.7b", tp=2, batch_axes=("data",))
    cfg = cfg.replace(n_layers=len(cfg.pattern), remat=False,
                      moe=dataclasses.replace(cfg.moe, dispatch_groups=2))
    msd = {"data": 2, "model": 2}
    with dryrun.fake_world(4):
        mesh = make_mesh(msd, "cuda")
        params = T.init_params(cfg, device="meta")
        dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                  mesh)
        opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
        batch = {"tokens": _meta(2, 64, dtype=torch.int32),
                 "labels": _meta(2, 64, dtype=torch.int32)}
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
        new, _, metrics = make_train_step(cfg, opt)(
            dparams, adamw_init(dparams, opt), dbatch)
    assert tuple(dbatch["tokens"].to_local().shape) == (1, 64)
    assert metrics["loss"].shape == ()
    assert [tuple(t.shape) for t in tree_leaves(new)] == \
        [tuple(t.shape) for t in tree_leaves(params)]


def test_moe_rows_follow_a_batch_the_batch_axes_do_not_all_divide():
    """The same step on (pod 2, data 2, model 1) with two rows: the input
    batch splits over 'pod' only and the pinned hidden stream over 'pod'
    and 'data' (one row on rank 0, none on some ranks), while the MoE's
    128 (B·S) rows split over the batch axes that divide its two dispatch
    groups; DTensor merges and splits them only through a divisible
    layout of the B rows (jamba train_4k's 16-row microbatches on the
    512-rank mesh)."""
    cfg = smoke_config("qwen2-moe-a2.7b", tp=1, batch_axes=("pod", "data"))
    cfg = cfg.replace(n_layers=len(cfg.pattern), remat=False,
                      moe=dataclasses.replace(cfg.moe, dispatch_groups=2))
    msd = {"pod": 2, "data": 2, "model": 1}
    with dryrun.fake_world(4):
        mesh = make_mesh(msd, "cuda")
        params = T.init_params(cfg, device="meta")
        dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                  mesh)
        opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
        batch = {"tokens": _meta(2, 64, dtype=torch.int32),
                 "labels": _meta(2, 64, dtype=torch.int32)}
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
        _, _, metrics = make_train_step(cfg, opt)(
            dparams, adamw_init(dparams, opt), dbatch)
    assert tuple(dbatch["tokens"].to_local().shape) == (1, 64)
    assert metrics["loss"].shape == ()


def test_jamba_fsdp_projections_keep_the_sequence_whole(monkeypatch):
    """Smoke jamba (FSDP: its big weights sharded over 'data' as well) on a
    cuda-typed fake mesh (pod 2, data 2, model 1), a train step of two rows
    (jamba train_4k's 16-row microbatches on the 512-rank mesh): the input
    batch splits over 'pod' alone, the pinned hidden stream over 'pod' and
    'data', one row on rank 0.  Contracting an activation replicated over
    'data' against a weight's shard there leaves partial sums, which DTensor
    reduce-scatters onto the sequence dim; torch 2.11 then refuses the
    product's backward (ROADMAP Queue 3 #9).  With each layer's FSDP
    weights gathered over 'data' at its entry, no Mamba projection's
    output (nor the out-projection's) holds partial sums, and neither it
    nor its gradient is sharded on the sequence dim."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import mamba2

    seen = []

    def record(name, t):
        if isinstance(t, DTensor):
            seen.append((name, "out", tuple(t.placements)))
            if t.requires_grad:
                t.register_hook(lambda g: seen.append(
                    (name, "grad", tuple(g.placements))))

    project, run_ssd = mamba2._project, mamba2._run_ssd

    def project_rec(params, u, cfg):
        outs = project(params, u, cfg)
        for name, t in zip(("z", "x_raw", "bc_raw", "dt"), outs):
            record(name, t)
        return outs

    def run_ssd_rec(*args, **kw):
        out, state = run_ssd(*args, **kw)
        record("out_proj", out)
        return out, state

    monkeypatch.setattr(mamba2, "_project", project_rec)
    monkeypatch.setattr(mamba2, "_run_ssd", run_ssd_rec)
    cfg = smoke_config("jamba-1.5-large-398b", tp=1,
                       batch_axes=("pod", "data"))
    assert cfg.fsdp
    msd = {"pod": 2, "data": 2, "model": 1}
    with dryrun.fake_world(4):
        mesh = make_mesh(msd, "cuda")
        params = T.init_params(cfg, device="meta")
        dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                  mesh)
        assert any(isinstance(p, Shard) for p in
                   dparams["blocks"][0]["mamba"]["wx"].placements)
        opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
        batch = {"tokens": _meta(2, 64, dtype=torch.int32),
                 "labels": _meta(2, 64, dtype=torch.int32)}
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
        _, _, metrics = make_train_step(cfg, opt)(
            dparams, adamw_init(dparams, opt), dbatch)
    assert tuple(dbatch["tokens"].to_local().shape) == (1, 64)
    assert metrics["loss"].shape == ()
    kinds = {(name, kind) for name, kind, _ in seen}
    n_mamba = [s.mixer for s in cfg.pattern].count("mamba")
    assert {(n, k) for n in ("z", "x_raw", "bc_raw", "dt", "out_proj")
            for k in ("out", "grad")} <= kinds
    assert len(seen) >= 10 * n_mamba
    bad = [(name, kind, pl) for name, kind, pl in seen
           if any(p.is_partial() or (isinstance(p, Shard) and p.dim == 1)
                  for p in pl)]
    assert not bad, bad


@pytest.mark.parametrize("chunks", [2, 4])
def test_fsdp_head_gathered_once_for_every_loss_chunk(chunks):
    """An FSDP head (its d_model rows sharded over 'data') is all-gathered
    once for the whole loss, and its gradient reduce-scattered once, however
    many chunks ``chunked_cross_entropy`` splits the sequence into: the same
    collectives as one chunk, forward and backward, not one gather a chunk
    and another in each chunk's recomputation."""
    from repro_torch.models.common import chunked_cross_entropy

    b, s, d, v = 4, 64, 32, 128

    def counts(n_chunks):
        with dryrun.fake_world(4):
            mesh = make_mesh({"data": 4}, "cuda")
            head = distribute_tensor(torch.empty(d, v, device="meta"), mesh,
                                     [Shard(0)]).requires_grad_()
            hidden = distribute_tensor(torch.empty(b, s, d, device="meta"),
                                       mesh, [Shard(0)]).requires_grad_()
            labels = distribute_tensor(
                torch.zeros(b, s, dtype=torch.int32, device="meta"), mesh,
                [Shard(0)])
            with CollectiveCounter() as cc:
                loss = chunked_cross_entropy(hidden, labels, head,
                                             chunk=s // n_chunks)
                torch.autograd.grad(loss, (hidden, head))
        return cc.result()["counts"]

    one, many = counts(1), counts(chunks)
    assert one["all-gather"] >= 1 and one["reduce-scatter"] >= 1, one
    for kind in ("all-gather", "reduce-scatter"):
        assert many[kind] == one[kind], (kind, one, many)


def test_gather_fsdp_gathers_where_the_layout_needs_it():
    """``shards.gather_fsdp``'s rule, leaf by leaf, on (data 2, model 2): a
    matrix whose rows (its input dim) are split over 'data' is gathered
    there, keeping its 'model' split, under autograd always and without it
    only when it meets at least as many rows of ``x`` as it has input dims;
    an expert stack split over 'data' on its expert dim, a vector and a
    matrix split over 'model' alone stay as they are; an expert stack split
    on its input dim counts the rows each expert meets."""
    from repro_torch.parallel.shards import gather_fsdp

    d, f, e = 64, 32, 4
    with dryrun.fake_world(4):
        mesh = make_mesh({"data": 2, "model": 2}, "cuda")

        def put(shape, pl):
            return distribute_tensor(torch.empty(shape, device="meta"),
                                     mesh, pl)

        tree = {"w": put((d, f), [Shard(0), Shard(1)]),
                "tp": put((d, f), [Replicate(), Shard(1)]),
                "experts": put((e, d, f), [Shard(0), Replicate()]),
                "stack": put((e, d, f), [Shard(1), Replicate()]),
                "norm": put((d,), [Replicate(), Replicate()])}
        few, many = _meta(2, 1, d), _meta(2, 64, d)   # 2 and 128 rows
        for x, grad, gathered in ((few, False, ()), (many, False, ("w",)),
                                  (_meta(2, 1, d).requires_grad_(), True,
                                   ("w", "stack"))):
            with torch.set_grad_enabled(grad):
                out = gather_fsdp(tree, x)
            for k, t in out.items():
                want = [Replicate(), tree[k].placements[1]] \
                    if k in gathered else list(tree[k].placements)
                assert list(t.placements) == want, (k, grad, t.placements)
        # 512 rows: 128 an expert, at least the stack's 64 input dims
        out = gather_fsdp(tree, _meta(8, 64, d))
        assert list(out["stack"].placements) == [Replicate(), Replicate()]


# ------------------------------------------- the layout's share, pinned --

class _ByProduct(dryrun._CellCost):
    """``dryrun``'s counter, with each local ``aten.mm``'s FLOPs kept by its
    operands' shapes."""

    def __init__(self, args):
        super().__init__(args)
        self.mm = {}

    def local_op(self, func, args, kwargs, out) -> None:
        before = self.flops
        super().local_op(func, args, kwargs, out)
        if str(func.overloadpacket) == "aten.mm":
            key = tuple(tuple(a.shape) for a in args[:2])
            self.mm[key] = self.mm.get(key, 0) + self.flops - before


def _one_layer_cell(arch: str, shape: str, seq: int, microbatches: int = 1):
    """One layer of ``arch`` at full width, ``shape`` cut to ``seq``,
    traced on the 256-rank fake mesh: (cfg, cell, the product counter,
    with the bytes of a device's parameter shards as ``param_bytes``)."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        cell = dataclasses.replace(SHAPES[shape], seq_len=seq)
        cfg = dryrun.dryrun_cfg(arch, mesh, kind=cell.kind).replace(
            n_layers=1)
        fn, args = dryrun._trace_cell(cfg, cell, mesh,
                                      microbatches=microbatches)
        ss.reset_meta_flops()
        with _ByProduct(args) as cost:
            fn(*args)
        cost.param_bytes = dryrun._nbytes(args[0])
    return cfg, cell, cost


def test_olmo_layer_prefill_products_are_the_layouts_share():
    """One olmo-1b layer, prefill of 32 rows of 8192 tokens on (data 16,
    model 16): each device multiplies its 2 rows by the reference's shards
    (q/k/v and the MLP's ff by columns, both out-projections by rows, the
    lm head by vocab at the last position).  torch 2.13 had multiplied the
    MLP's wi and wg whole (1.168e12 FLOP), because attention's output
    reached them as partial sums over 'model'."""
    cfg, cell, cost = _one_layer_cell("olmo-1b", "prefill_32k", 8192)
    tp = 16
    rows = cell.global_batch // 16 * cell.seq_len
    d, dh, ff = cfg.d_model, cfg.d_head, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    want = (2 * rows * d * (hq + 2 * hkv) * dh // tp        # q, k, v
            + 2 * rows * hq * dh // tp * d                  # attention wo
            + 3 * 2 * rows * d * ff // tp                   # wi, wg, wo
            + 2 * (cell.global_batch // 16) * d * cfg.vocab // tp)  # head
    assert sum(cost.mm.values()) == want, cost.mm


def test_mamba_layer_train_products_are_the_layouts_share():
    """One mamba2-1.3b layer, a train_4k step cut to 1024 tokens in 8
    microbatches on (data 16, model 16): every product, forward (twice
    under remat, and the loss's chunk recomputed), input gradient and
    weight gradient, at the reference's shard: z, x and dt by columns of
    d_inner (1/16), out_proj by rows, the lm head by d (its vocab of 50280
    does not divide 16); B/C whole, as the reference replicates them.
    torch 2.13 had computed the in-projections' weight gradients and the
    lm head's whole."""
    mb = 8
    cfg, cell, cost = _one_layer_cell("mamba2-1.3b", "train_4k", 1024, mb)
    tp, s = 16, cfg.ssm
    rows = cell.global_batch // 16 // mb * cell.seq_len
    d, v = cfg.d_model, cfg.vocab
    # forward (again under remat), dx, dW; remat's recomputation stops at
    # the last tensor a backward saved, out_proj's input, so out_proj's
    # forward runs once; the loss recomputes each chunk's logits
    passes = (2 if cfg.remat else 1) + 2
    in_proj = 2 * rows * d * (2 * s.d_inner + s.n_heads) // tp
    b_c = 2 * rows * d * s.d_bc
    out_proj = 2 * rows * s.d_inner // tp * d
    head = 2 * rows * d // tp * v
    want = mb * (passes * (in_proj + b_c) + 3 * out_proj + 4 * head)
    assert cost.mm[((d // tp, rows), (rows, v))] == mb * head  # head's dW
    assert not [k for k in cost.mm if any(s.d_inner in a for a in k)], \
        cost.mm                               # no product at all d_inner
    assert sum(cost.mm.values()) == want, cost.mm


def test_tp_matmul_places_each_product_by_the_weights_layout():
    """``shards.tp_matmul`` on (data 2, model 2): a column split, a row
    split (reduced at once onto the rows), an activation that arrives as
    partial sums over 'model' (reduced before the column split, never the
    weight gathered), an expert stack split over 'data', an FSDP weight
    left split over 'data' (partial sums reduce-scattered onto the rows);
    each split read from the weight's placements and each local product at
    its share; a stack split over 'model' is refused; plain tensors
    multiply as ``@``."""
    from torch.distributed.tensor import Partial
    from repro_torch.parallel.shards import tp_matmul

    with dryrun.fake_world(4):
        mesh = make_mesh({"data": 2, "model": 2}, "cuda")

        def put(shape, pl):
            return distribute_tensor(_meta(*shape), mesh, pl,
                                     src_data_rank=None)

        def run(x, w):
            with dryrun._CellCost((x, w)) as cost:
                y = tp_matmul(x, w)
            return y, cost

        cases = [
            ((4, 8, 16), [Shard(0), Replicate()], (16, 32),
             [Replicate(), Shard(1)], [Shard(0), Shard(2)],
             2 * 2 * 8 * 16 * 16, {}),
            ((4, 8, 32), [Shard(0), Shard(2)], (32, 16),
             [Replicate(), Shard(0)], [Shard(0), Replicate()],
             2 * 2 * 8 * 16 * 16, {"all-reduce": 1}),
            ((4, 8, 16), [Shard(0), Partial()], (16, 32),
             [Replicate(), Shard(1)], [Shard(0), Shard(2)],
             2 * 2 * 8 * 16 * 16, {"all-reduce": 1}),
            ((4, 6, 16), [Shard(0), Replicate()], (4, 16, 32),
             [Shard(0), Shard(2)], [Shard(0), Shard(2)],
             2 * 2 * 6 * 16 * 16, {}),
            ((4, 8, 16), [Shard(0), Replicate()], (16, 32),
             [Shard(0), Shard(1)], [Shard(0), Shard(2)],
             2 * 4 * 8 * 8 * 16, {"all-to-all": 1, "reduce-scatter": 1}),
        ]
        for xs, xpl, ws, wpl, want_pl, flops, colls in cases:
            y, cost = run(put(xs, xpl), put(ws, wpl))
            assert list(y.placements) == want_pl, (xs, ws, y.placements)
            assert tuple(y.shape) == xs[:-1] + ws[-1:]
            assert cost.flops == flops, (xs, ws, cost.flops)
            counts = {k: n for k, n in cost.result()["counts"].items() if n}
            assert counts == colls, (xs, ws, counts)
            assert not any(p.is_partial() for p in y.placements)
        with pytest.raises(ValueError, match="stack dim"):
            tp_matmul(put((4, 6, 16), [Shard(0), Replicate()]),
                      put((4, 16, 32), [Replicate(), Shard(0)]))
    x, w = torch.randn(3, 5, 4), torch.randn(4, 6)
    assert torch.equal(tp_matmul(x, w), x @ w)


@pytest.mark.parametrize("rank", [0, 3, 6])
def test_local_shape_matches_distribute_tensor(rank):
    """``shards.local_shape`` against ``distribute_tensor(...).to_local()``
    on a fake (pod 2, data 2, model 2) mesh, as rank ``rank``: uneven sizes
    (a last shard short, or empty), one dim split by two mesh dims, and
    replicated dims."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.parallel.shards import local_shape

    cases = [((5, 7, 3), [Shard(0), Shard(0), Shard(1)]),
             ((3, 9), [Shard(1), Replicate(), Shard(0)]),
             ((6, 4), [Replicate(), Replicate(), Replicate()]),
             ((1, 5, 2), [Shard(0), Shard(1), Shard(1)]),
             ((16, 3, 32, 4), [Shard(0), Shard(0), Shard(2)])]
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    try:
        mesh = make_mesh({"pod": 2, "data": 2, "model": 2}, "cuda")
        for shape, pl in cases:
            want = distribute_tensor(_meta(*shape), mesh, pl,
                                     src_data_rank=None).to_local().shape
            assert local_shape(shape, mesh, pl) == tuple(want), (shape, pl)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_meta_cache_holds_only_its_shard(arch):
    """``init_cache(..., device="meta", mesh=)`` with the batch over
    ('pod', 'data') on (pod 2, data 2, model 2) makes nothing but each
    leaf's shard: the dry run's peak is the cache's shard bytes (ROADMAP
    Queue 3 #10: a shape helper's partly sharded copy had been counted,
    114,692 / 51,460 / 130,820 B)."""
    cfg = smoke_config(arch, tp=2, batch_axes=("pod", "data"))
    with dryrun.fake_world(8):
        mesh = make_mesh({"pod": 2, "data": 2, "model": 2}, "cuda")
        with dryrun._CellCost(()) as cost:
            cache = T.init_cache(cfg, 8, 64, device="meta", mesh=mesh)
    shard = dryrun._nbytes(cache)
    assert shard > 0
    assert shard <= cost.peak <= shard + 16, (cost.peak, shard)


# --------------------------------------------- the loss at its shard --

class _Made(dryrun._CellCost):
    """``dryrun``'s counter, with the shape of every tensor a local op
    makes, views and collectives left out (an all-gather over a dim other
    than the first stacks the ranks' pieces along the first dim of its
    result buffer, which the next op rearranges)."""

    def __init__(self, args):
        super().__init__(args)
        self.shapes = []

    def local_op(self, func, args, kwargs, out) -> None:
        super().local_op(func, args, kwargs, out)
        name = str(func.overloadpacket)
        if not getattr(func, "is_view", False) \
                and not name.startswith("_c10d_functional."):
            self.shapes += [tuple(t.shape) for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("vocab", [512, 511])
def test_loss_makes_only_its_rows(vocab):
    """Smoke olmo-1b's ``chunked_cross_entropy``, forward and backward, on a
    fake (pod 2, data 2, model 2) mesh: 16 rows of 64 tokens over ('pod',
    'data'), 4 a device, in chunks of 32.  A vocab of 512 splits the head
    over 'model' (256 columns a device); 511 does not divide, so the head
    is split on d and the logits are whole over the vocab.  No tensor the
    loss makes has more batch rows than the device's 4 (a 3-dim tensor's
    first dim), nor, among those whose last dim is a vocab width (the
    head's own (d, columns) shape left out), more token rows than its 4 x
    32 of a chunk; with the vocab split, none has all 512 columns.
    DTensor's ``take_along_dim`` backward had made a replicated (16, 32,
    vocab) zero tensor, and the split vocab had been gathered whole."""
    from repro_torch.models.common import chunked_cross_entropy

    cfg = smoke_config("olmo-1b", tp=2, batch_axes=("pod", "data"),
                       vocab=vocab)
    msd = {"pod": 2, "data": 2, "model": 2}
    b, s, d, rows = 16, 64, cfg.d_model, 4
    with dryrun.fake_world(8):
        mesh = make_mesh(msd, "cuda")
        params = T.init_params(cfg, device="meta")
        dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                  mesh)
        head = dparams["lm_head"].requires_grad_()
        batch = {"hidden": _meta(b, s, d), "labels": _meta(
            b, s, dtype=torch.int32)}
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
        hidden = dbatch["hidden"].requires_grad_()
        with _Made((hidden, head, dbatch["labels"])) as made:
            loss = chunked_cross_entropy(hidden, dbatch["labels"], head,
                                         chunk=cfg.loss_chunk,
                                         norm_kind=cfg.norm)
            torch.autograd.grad(loss, (hidden, head))
    split = vocab % 2 == 0
    cols = vocab // 2 if split else vocab
    head_local = tuple(head.to_local().shape)
    assert head_local == ((d, cols) if split else (d // 2, vocab))
    assert tuple(hidden.to_local().shape) == (rows, s, d)
    assert (rows, cfg.loss_chunk, cols) in made.shapes  # a chunk's logits
    widths = {vocab, cols}
    bad = [t for t in made.shapes
           if (len(t) >= 3 and t[0] > rows)
           or (t and t[-1] in widths and t[:1] != head_local[:1]
               and math.prod(t[:-1]) > rows * cfg.loss_chunk)
           or (split and vocab in t)]
    assert not bad, sorted(set(bad))


def test_olmo_layer_train_peak_is_the_shards():
    """One olmo-1b layer, a train_4k step cut to 512 tokens at its
    production two microbatches on (data 16, model 16): 8 rows of 512 a
    device in each, the head split over the vocab, 3,144 columns a device.
    The step's peak is then the gradients' and AdamW's float32 temporaries
    of the largest leaf (the replicated 50304 x 2048 embedding table): it
    stays below six float32 copies of the device's parameter shards (2.73
    GB; 1.96 GB counted).  The loss's own float32 storage, a few copies of
    (8, 512, 3144), is far below that; the whole microbatch's (128, 512,
    50304) gradient that DTensor's ``take_along_dim`` had made, 13.19 GB,
    and its rows' logits gathered whole over the vocab, 0.82 GB a copy,
    were not."""
    _, _, cost = _one_layer_cell("olmo-1b", "train_4k", 512, 2)
    bound = 6 * 2 * cost.param_bytes     # bfloat16 weights, float32 copies
    assert cost.peak < bound, (cost.peak, bound)
