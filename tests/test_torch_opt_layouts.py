"""The reference's hillclimbed layouts (``launch/optconfig.py:OPT_OVERRIDES``,
the dry run's ``--opt``) on the port.

* The ``dp`` layout's train step (parameters replicated, ZeRO-1 moments
  over ('data', 'model'), the batch over both): smoke olmo-1b, 16 rows of
  64 tokens on (data 4, model 2).  The reference's step is compiled on 8
  host devices in a subprocess (``XLA_FLAGS`` set there only), its
  parameters and moments kept in their layouts across the step, and its
  collectives counted by ``repro.launch.hloparse.parse_collectives``: one
  all-reduce of the gradients and one all-gather of the new parameters.
  The port's step on a fake 8-rank meta mesh, counted by
  ``commcount.CollectiveCounter``, moves no more in all and all-reduces no
  more, and reduces each gradient once: into its moments' shard, by one
  reduce-scatter over both mesh dims (``shards.relayout``), before the
  global norm, which is then one scalar all-reduce.  Before, the norm
  all-reduced every gradient over each mesh dim in turn and the update
  reduce-scattered it again (1,544,208 B against the reference's 983,092).
* olmo-1b ``train_4k`` opt on the 256-rank mesh at production size: its
  arguments are the reference's shard arithmetic for the opt config, and
  its all-reduces under 1% of the float32 gradient's bytes (10.24 GB
  before).
* An int8 KV cache (``kv_quant``) in an opt ``decode_32k`` cell: each
  cache leaf's shard (int8 values, float32 scales) is the reference's
  ``cache_specs`` arithmetic.
"""
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.parallel as JPAR
from repro.configs import SHAPES as J_SHAPES
from repro.launch import specs as JS
from repro.launch.optconfig import build_cfg as j_build_cfg
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import SHAPES, smoke_config
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch.commcount import _OPS, CollectiveCounter
from repro_torch.launch import specs as S
from repro_torch.launch.optconfig import build_cfg
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import (batch_specs, distribute_tree,
                                  param_specs, zero1_specs)
from repro_torch.parallel.sharding import P
from repro_torch.train import make_train_step
from repro_torch.tree import SEP, flatten, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
DP_MESH = {"data": 4, "model": 2}
ROWS, SEQ = 16, 64

REF_SCRIPT = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.launch.hloparse import parse_collectives
    from repro.models import transformer as T
    from repro.optim import AdamWConfig, adamw_init
    from repro.parallel import batch_specs, param_specs, zero1_specs
    from repro.train import make_train_step
    cfg = smoke_config("olmo-1b", tp=2, layout="dp",
                       batch_axes=("data", "model"))
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    msd = {DP_MESH!r}
    params = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    opt = AdamWConfig()
    o = jax.eval_shape(lambda p: adamw_init(p, opt), params)
    b = {{k: jax.ShapeDtypeStruct(({ROWS}, {SEQ}), jnp.int32)
         for k in ("tokens", "labels")}}
    ps = param_specs(cfg, params, msd)
    zs = zero1_specs(ps, params, msd, axes=("data", "model"))

    def ns(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    # parameters and moments leave the step in the layouts they came in
    ins = (ns(ps), ns({{"m": zs, "v": zs, "step": P()}}),
           ns(batch_specs(cfg, b, msd)))
    step = make_train_step(cfg, opt, num_microbatches=1)
    with mesh:
        hlo = jax.jit(step, in_shardings=ins,
                      out_shardings=(ins[0], ins[1], None)).lower(
            params, o, b).compile().as_text()
    print(json.dumps(parse_collectives(hlo)))
""")


def _reference_collectives() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


class _Reductions(CollectiveCounter):
    """Also records, for each all-reduce and reduce-scatter, its input's
    dims (sorted: a reduce-scatter's input has its scattered dim first)."""

    def __init__(self):
        super().__init__()
        self.inputs = Counter()

    def local_op(self, func, args, kwargs, out) -> None:
        super().local_op(func, args, kwargs, out)
        hit = _OPS.get(str(func.overloadpacket))
        if hit and hit[0] in ("all-reduce", "reduce-scatter") \
                and isinstance(args[0], torch.Tensor):
            self.inputs[tuple(sorted(args[0].shape))] += 1


def _port_dp_step() -> tuple:
    """(collectives, reductions by input dims, gradient leaves by dims) of
    the port's dp step on a fake (data 4, model 2) meta mesh."""
    cfg = smoke_config("olmo-1b", tp=2, layout="dp",
                       batch_axes=("data", "model"))
    with dryrun.fake_world(8):
        mesh = make_mesh(DP_MESH, "cuda")
        params = T.init_params(cfg, device="meta")
        ps = param_specs(cfg, params, DP_MESH)
        opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
        zs = zero1_specs(ps, params, DP_MESH, axes=("data", "model"))
        dopt = distribute_tree(adamw_init(params, opt),
                               {"m": zs, "v": zs, "step": P()}, mesh)
        batch = {k: torch.empty((ROWS, SEQ), dtype=torch.int32,
                                device="meta")
                 for k in ("tokens", "labels")}
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, DP_MESH),
                                 mesh)
        dparams = distribute_tree(params, ps, mesh)
        with _Reductions() as counter:
            new_p, new_o, _ = make_train_step(cfg, opt)(dparams, dopt,
                                                        dbatch)
        for got, want in ((new_p, dparams), (new_o["m"], dopt["m"])):
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert a.placements == b.placements
    leaves = Counter(tuple(sorted(p.shape)) for p in tree_leaves(params))
    return counter.result(), counter.inputs, leaves


def test_dp_step_reduces_each_gradient_once_within_the_reference():
    ref = _reference_collectives()["looped"]
    # the reference's step: the gradients all-reduced once (with two
    # scalars) and the new parameters all-gathered once
    assert ref["all-gather"] == 425_984 and ref["reduce-scatter"] == 0
    coll, reductions, leaves = _port_dp_step()
    got = coll["looped"]
    assert got["total"] <= ref["total"], (got, ref)
    assert got["all-reduce"] <= ref["all-reduce"], (got, ref)
    assert got["all-gather"] <= ref["all-gather"], (got, ref)
    # every gradient is reduce-scattered once into its 1/8 shard (the
    # parameters' 425,984 float32 bytes / 8), and nothing else is reduced
    # but scalars
    assert got["reduce-scatter"] == 425_984 // 8
    for dims, n in reductions.items():
        assert n <= leaves.get(dims, 0) or dims == (), (dims, n)
    assert sum(reductions[d] for d in leaves) == sum(leaves.values())


# ------------------------------------------------------- production cells --

def _shard_bytes(tree, specs, mesh: dict) -> int:
    """Each leaf's bytes divided by the sizes of the mesh axes its spec
    names (``tests/test_distribution.py:58-78``)."""
    total = 0
    for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))):
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for ax in tuple(s):
            for a in () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax:
                n //= mesh[a]
        total += n
    return total


def _reference_opt_argument_bytes(arch: str, shape: str,
                                  mesh_name: str) -> int:
    """The shard arithmetic of the reference's arguments of the opt cell
    (the cache's position left out: a Python int in the port)."""
    mesh = MESHES[mesh_name]
    cell = J_SHAPES[shape]
    jc = j_build_cfg(arch, mesh, opt=True, kind=cell.kind)
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
    else:
        b = JS.decode_input_specs(jc, cell)
        c = dict(JS.cache_shapes(jc, cell))
        c.pop("pos")
        total += _shard_bytes(c, JPAR.cache_specs(jc, c, mesh), mesh)
    return total + _shard_bytes(b, JPAR.batch_specs(jc, b, mesh), mesh)


def test_olmo_train_opt_cell_all_reduces_no_gradient():
    """olmo-1b ``train_4k`` opt, single pod (``layout="dp"``, one
    microbatch): the arguments are the reference's shards, and the step
    all-reduces less than 1% of the float32 gradient's bytes (the
    scalars alone; 10.24 GB a device when the norm reduced each gradient
    over each mesh dim); each gradient is reduce-scattered once onto its
    1/256 shard and the new parameters all-gathered once."""
    ss.reset_launches()
    rec = dryrun.run_cell("olmo-1b", "train_4k", verbose=False, opt=True)
    assert rec["status"] == "ok" and rec["layout"] == "dp"
    assert rec["opt"] is True and rec["microbatches"] == 1
    assert rec["memory"]["argument_bytes"] == \
        _reference_opt_argument_bytes("olmo-1b", "train_4k", "single_pod")
    shapes = tree_leaves(S.params_shapes(build_cfg(
        "olmo-1b", MESHES["single_pod"], opt=True)))
    n_params = sum(int(np.prod(s.shape)) for s in shapes)
    # the dry run's weights and gradients are bfloat16
    grad_bytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                     for s in shapes)
    coll = rec["collective_bytes_per_device"]
    assert coll["all-reduce"] < 0.01 * 4 * n_params, coll
    assert coll["reduce-scatter"] == grad_bytes // 256, coll
    assert coll["all-gather"] == grad_bytes, coll
    assert ss.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}


@pytest.mark.parametrize("arch,mesh_name", [("olmo-1b", "single_pod"),
                                            ("qwen2-moe-a2.7b", "multi_pod")])
def test_int8_cache_shards_are_the_reference(arch, mesh_name):
    """An opt ``decode_32k`` cell with an int8 KV cache: every cache leaf
    (int8 ``k_q``/``v_q``, float32 scales ``k_s``/``v_s``) is allocated at
    the shard the reference's ``cache_specs`` gives it, and the cell's
    arguments are the reference's shard arithmetic."""
    mesh_shape = MESHES[mesh_name]
    jc = j_build_cfg(arch, mesh_shape, opt=True, kind="decode")
    jcache = dict(JS.cache_shapes(jc, J_SHAPES["decode_32k"]))
    jcache.pop("pos")
    jspecs = JPAR.cache_specs(jc, jcache, mesh_shape)
    shards = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(jcache),
            jax.tree_util.tree_leaves(jspecs,
                                      is_leaf=lambda x: isinstance(x, JP))):
        shape = list(leaf.shape)
        for i, ax in enumerate(tuple(spec)):
            for a in () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax:
                shape[i] //= mesh_shape[a]
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        shards[key] = (tuple(shape), str(leaf.dtype))
    with dryrun.fake_world(512 if mesh_name == "multi_pod" else 256):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi_pod",
                                    device_type="cuda")
        cfg = dryrun.dryrun_cfg(arch, mesh, opt=True, kind="decode")
        assert cfg.kv_quant
        _, (_, _, cache) = dryrun._trace_cell(cfg, SHAPES["decode_32k"],
                                              mesh)
        got = {k: (tuple(v.to_local().shape),
                   str(v.to_local().dtype).replace("torch.", ""))
               for k, v in flatten(cache).items()
               if isinstance(v, torch.Tensor)}
    got = {k.replace(SEP, "/"): v for k, v in got.items()}
    assert any(k.endswith("k_q") for k in got)
    assert got == shards
    rec = dryrun.run_cell(arch, "decode_32k", verbose=False, opt=True,
                          multi_pod=mesh_name == "multi_pod")
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_bytes"] == \
        _reference_opt_argument_bytes(arch, "decode_32k", mesh_name)
