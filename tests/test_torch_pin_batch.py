"""The hidden stream pinned over every batch axis, as the reference pins it.

* The reference's ``_pin_batch`` (``src/repro/models/transformer.py``)
  pins dim 0 of the hidden stream to all of ``cfg.batch_axes`` with no
  divisibility rule, and XLA pads rows the axes do not divide.  Its
  compiled train step (smoke olmo-1b on (pod 2, data 4), 16 rows in four
  microbatches of 4, in a subprocess with 8 host devices) holds one row
  of each microbatch a device in its layer scan; the port's step on a
  fake 8-rank meta mesh holds one on rank 0 (and none on some ranks).
* Where the axes divide the rows, the pin's placements are
  ``batch_specs``' rule, as before: for every (arch x shape x mesh) cell
  of the production meshes the pinned hidden stream is laid out as the
  divisible rule lays it out, or, where the rows are fewer than the ranks
  or do not divide, split over all batch axes with ``ceil(rows / ranks)``
  rows on rank 0.
* ``on_shards`` gives an uneven output its global shape from the inputs
  (``local_map`` would claim local rows times the ranks), and the MoE's
  B·S rows split over all batch axes where its dispatch groups divide
  (``shards.merge_rows``: one all-to-all from the pinned rows).
* The kernel wrappers' plain versions on zero rows: empty outputs and
  gradients (the card's kernels are held to the same, with no launch, in
  ``tests/test_torch_cuda.py``).
"""
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import ARCH_IDS, SHAPES, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.optconfig import build_cfg, microbatches_for
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import batch_specs, distribute_tree, param_specs
from repro_torch.parallel.shards import local_shape, on_shards
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
# the reference's step and the port's: smoke olmo-1b on (pod 2, data 4,
# model 1), 16 rows of SEQ tokens in four microbatches (a sequence length
# no weight dim has, so the hidden stream's shape names it alone)
SEQ = 40
REF_SCRIPT = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import collections, json, re
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.models import transformer as T
    from repro.optim import AdamWConfig, adamw_init
    from repro.parallel import batch_specs, param_specs
    from repro.train import make_train_step
    cfg = smoke_config("olmo-1b", tp=1, batch_axes=("pod", "data"))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4, 1),
                ("pod", "data", "model"))
    msd = {{"pod": 2, "data": 4, "model": 1}}
    params = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    opt = AdamWConfig()
    o = jax.eval_shape(lambda p: adamw_init(p, opt), params)
    b = {{k: jax.ShapeDtypeStruct((16, {SEQ}), jnp.int32)
         for k in ("tokens", "labels")}}

    def ns(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    step = make_train_step(cfg, opt, num_microbatches=4)
    with mesh:
        hlo = jax.jit(step, in_shardings=(
            ns(param_specs(cfg, params, msd)), None,
            ns(batch_specs(cfg, b, msd)))).lower(params, o, b).compile(
            ).as_text()
    # rows of every (rows, SEQ, d) float32 result of the forward's layer
    # scan (a while loop inside the microbatch loop)
    rows = collections.Counter()
    for line in hlo.splitlines():
        m = re.search(rf"= f32\\[(\\d+),{SEQ},{{cfg.d_model}}\\]", line)
        if m and "jvp()/while/body" in line:
            rows[int(m.group(1))] += 1
    print(json.dumps(sorted(rows)))
""")


def _reference_layer_rows() -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def _port_pinned_rows(arch: str = "olmo-1b") -> list:
    """The local rows, on rank 0 of a fake (pod 2, data 4, model 1) mesh,
    of every hidden stream ``_pin_batch`` returns in the port's step on the
    reference's inputs (meta tensors)."""
    rows: list = []
    pin = T._pin_batch

    def record(cfg, x):
        y = pin(cfg, x)
        if isinstance(y, DTensor):
            rows.append(int(y.to_local().shape[0]))
        return y

    cfg = smoke_config(arch, tp=1, batch_axes=("pod", "data"))
    msd = {"pod": 2, "data": 4, "model": 1}
    T._pin_batch = record
    try:
        with dryrun.fake_world(8):
            mesh = make_mesh(msd, "cuda")
            params = T.init_params(cfg, device="meta")
            dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                      mesh)
            opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
            batch = {k: torch.empty((16, SEQ), dtype=torch.int32,
                                    device="meta")
                     for k in ("tokens", "labels")}
            dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd),
                                     mesh)
            _, _, metrics = make_train_step(cfg, opt, num_microbatches=4)(
                dparams, adamw_init(dparams, opt), dbatch)
            assert tuple(dbatch["tokens"].to_local().shape) == (2, SEQ)
            assert metrics["loss"].shape == ()
    finally:
        T._pin_batch = pin
    return sorted(set(rows))


def test_reference_and_port_hold_one_row_of_a_microbatch_a_device():
    """Four rows over eight batch ranks: the reference pads them and each
    device's layer scan holds one row; the port's rank 0 holds one row of
    each pinned hidden stream (``batch_specs``' rule alone, which splits
    four rows over 'pod' only, would give it two)."""
    assert _reference_layer_rows() == [1]
    assert _port_pinned_rows() == [1]


def _pinned(cfg, mesh, rows: int):
    """``_pin_batch`` of a meta (rows, 8, 4) hidden stream laid out as
    ``batch_specs`` lays out a batch of ``rows`` rows."""
    msd = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shape = (rows, 8, 4)
    spec = batch_specs(cfg, {"x": torch.empty(shape, device="meta")},
                       msd)["x"]
    x = distribute_tree(torch.empty(shape, device="meta"), spec, mesh)
    return x, T._pin_batch(cfg, x), T._pin_divisible(cfg, x)


def _cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh_name in sorted(MESHES):
                yield arch, shape, mesh_name


@pytest.mark.parametrize("arch,shape,mesh_name", list(_cells()))
def test_pin_keeps_the_divisible_layout_of_every_cell(arch, shape,
                                                      mesh_name):
    """Each production cell's hidden stream (a microbatch's rows in train,
    the batch's in prefill and decode): where its batch axes divide the
    rows, pinned exactly as ``batch_specs``' rule pins it (so those cells
    keep their counts); where they do not (multi-pod train_4k of
    qwen1.5-32b and jamba, 16 rows over 32 ranks; long_500k, one row),
    split over every batch axis, rank 0 holding ``ceil(rows / ranks)``."""
    msd = MESHES[mesh_name]
    cell = SHAPES[shape]
    cfg = build_cfg(arch, msd, kind=cell.kind)
    specs = {"train": S.train_input_specs, "prefill": S.prefill_input_specs,
             "decode": S.decode_input_specs}[cell.kind](cfg, cell)
    rows = specs["tokens"].shape[0] // microbatches_for(arch, cell.kind,
                                                         False)
    ranks = math.prod(msd[a] for a in cfg.batch_axes)
    with dryrun.fake_world(math.prod(msd.values())):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi_pod",
                                    device_type="cuda")
        _, pinned, divisible = _pinned(cfg, mesh, rows)
    names = mesh.mesh_dim_names
    if rows % ranks == 0:
        assert pinned.placements == divisible.placements
    else:
        assert (arch, shape, mesh_name) in {
            ("qwen1.5-32b", "train_4k", "multi_pod"),
            ("jamba-1.5-large-398b", "train_4k", "multi_pod")} \
            or shape == "long_500k"
        assert pinned.placements == tuple(
            Shard(0) if n in cfg.batch_axes else Replicate() for n in names)
        assert pinned.to_local().shape[0] == -(-rows // ranks)
    assert tuple(pinned.shape) == (rows, 8, 4)


def test_pin_splits_rows_as_torch_chunk_does_on_every_rank():
    """Two rows over (pod 2, data 2): ``local_shape`` of the pinned
    layout gives 1, 0, 1, 0 rows by rank, the split the gloo ranks see;
    ``batch_specs``' rule keeps them over 'pod' alone."""
    cfg = smoke_config("olmo-1b", tp=1, batch_axes=("pod", "data"))
    with dryrun.fake_world(4):
        mesh = make_mesh({"pod": 2, "data": 2, "model": 1}, "cuda")
        x, pinned, divisible = _pinned(cfg, mesh, 2)
    assert divisible.placements == (Shard(0), Replicate(), Replicate())
    assert pinned.placements == (Shard(0), Shard(0), Replicate())
    by_rank = []
    for pod in range(2):
        for data in range(2):
            n = pinned.shape[0]
            full = -(-n // 2)
            n = max(0, min(full, n - pod * full))    # pod's chunk
            full = -(-n // 2)
            by_rank.append(max(0, min(full, n - data * full)))
    assert by_rank == [1, 0, 1, 0]
    assert local_shape(pinned.shape, mesh, pinned.placements)[0] == 1


def test_on_shards_gives_an_uneven_output_its_global_shape():
    """A function of each rank's rows on two rows over four ranks: the
    output keeps the input's global rows (2), where ``local_map`` would
    claim its local rows times the ranks (4)."""
    with dryrun.fake_world(4):
        mesh = make_mesh({"pod": 2, "data": 2, "model": 1}, "cuda")
        pl = (Shard(0), Shard(0), Replicate())
        x = DTensor.from_local(torch.empty((1, 8, 4), device="meta"), mesh,
                               pl, run_check=False, shape=(2, 8, 4),
                               stride=(32, 4, 1))
        y = on_shards(lambda t: t * 2.0, mesh, (x,), (pl,), (pl,))
        even = on_shards(lambda t: t * 2.0, mesh, (x.redistribute(
            mesh, (Shard(0), Replicate(), Replicate())),),
            ((Shard(0), Replicate(), Replicate()),),
            ((Shard(0), Replicate(), Replicate()),))
    assert tuple(y.shape) == (2, 8, 4)
    assert tuple(y.to_local().shape) == (1, 8, 4)
    assert y.placements == pl
    assert tuple(even.shape) == (2, 8, 4)


def test_moe_rows_split_over_every_batch_axis():
    """Smoke qwen2-moe on (pod 2, data 2, model 1), a train step of two
    rows of 64 in four dispatch groups (one a rank, as jamba's 32 groups
    over the 32 batch ranks of the 512-rank mesh): the hidden stream holds
    one row on rank 0, and the MoE's 128 (B·S) rows split over all four
    ranks, 32 a rank: fewer than the one row (64) that a device of the
    reference's padded layout holds."""
    cfg = smoke_config("qwen2-moe-a2.7b", tp=1, batch_axes=("pod", "data"))
    cfg = cfg.replace(n_layers=len(cfg.pattern), remat=False,
                      moe=dataclasses.replace(cfg.moe, dispatch_groups=4))
    msd = {"pod": 2, "data": 2, "model": 1}
    seen, pinned = [], []
    apply, pin = M.apply_moe, T._pin_batch

    def record_moe(p, x, c, *a, **k):
        seen.append((tuple(x.shape), tuple(x.to_local().shape)))
        return apply(p, x, c, *a, **k)

    def record_pin(c, x):
        y = pin(c, x)
        pinned.append(int(y.to_local().shape[0]))
        return y

    T.moe.apply_moe, T._pin_batch = record_moe, record_pin
    try:
        with dryrun.fake_world(4):
            mesh = make_mesh(msd, "cuda")
            params = T.init_params(cfg, device="meta")
            dparams = distribute_tree(params, param_specs(cfg, params, msd),
                                      mesh)
            opt = AdamWConfig(moment_dtype=cfg.opt_dtype)
            batch = {k: torch.empty((2, 64), dtype=torch.int32,
                                    device="meta")
                     for k in ("tokens", "labels")}
            dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd),
                                     mesh)
            make_train_step(cfg, opt)(dparams, adamw_init(dparams, opt),
                                      dbatch)
    finally:
        T.moe.apply_moe, T._pin_batch = apply, pin
    assert seen and set(seen) == {((128, cfg.d_model), (32, cfg.d_model))}
    assert set(pinned) == {1}


# ------------------------------------------------------------ zero rows --

def _ssd_inputs(bsz: int, dtype=torch.float32, device="cpu"):
    s, h, p, g, n = 40, 4, 64, 2, 64
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    return (rand(bsz, s, h, p), rand(bsz, s, h, dt=torch.float32).abs(),
            rand(h, dt=torch.float32), rand(bsz, s, g, n),
            rand(bsz, s, g, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_on_zero_rows_gives_an_empty_output(dtype):
    q = torch.zeros((0, 4, 16, 64), dtype=dtype)
    k = torch.zeros((0, 2, 16, 64), dtype=dtype)
    out = fa.flash_attention_cuda(q, k, k)
    assert out.shape == q.shape and out.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_wrapper_on_zero_rows_gives_empty_outputs_and_gradients(dtype):
    """The SSD forward (y and the final state) and ``SsdScan``'s backward
    on a batch of no rows: every output and gradient of its input's shape,
    empty where the input is, and a zero gradient of ``a_log``."""
    ins = [t.requires_grad_() for t in _ssd_inputs(0, dtype)]
    y, state = ss.ssd_scan_cuda(*ins, chunk=16, final_state=True)
    assert y.shape == ins[0].shape and y.dtype == dtype
    assert state.shape == (0, 4, 64, 64)
    (y.float().sum() + state.sum()).backward()
    for t in ins:
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
    assert not ins[2].grad.any()
