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
* Every arch's long_500k record: the reference's skip record, word for
  word, where the reference skips it.  ``repro.launch.dryrun`` is not
  imported (it sets ``XLA_FLAGS`` to 512 host devices when imported); its
  skip text is read from its source.
"""
import ast
import dataclasses
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
    """The same step on (pod 2, data 2, model 1) with two rows: the batch
    splits over 'pod' only, while its 128 (B·S) rows would split over
    'pod' and 'data'; the MoE's rows must follow the batch (jamba
    train_4k's 16-row microbatches on the 512-rank mesh)."""
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
