"""One dry-run cell's baseline and opt layouts at small size, the reference's
compiled HLO beside the port's eager collectives.

    PYTHONPATH=src python tools/opt_small_hlo.py ARCH {train,prefill} \\
        [--rows 16] [--seq 64] [--microbatches 1] [--repeats R] [--pods 2]
        [--port-only]

Both packages build the cell's config as ``launch/optconfig.py:build_cfg``
does for the production meshes, but on (data 4, model 2), or (pod 2, data
2, model 2) with ``--pods 2`` (a pod axis of size 1 otherwise): the
baseline, and
the opt overrides (``OPT_OVERRIDES``; layout and FSDP for train cells
only, the MoE's dispatch groups over 'data' where listed), with
``smoke_config``'s widths, or with the arch's own widths and ``R`` repeats
of its layer pattern when ``--repeats`` is given.  The weights are
bfloat16 and ``rows`` x ``seq`` tokens go through one prefill or one train
step (ZeRO-1 moments; parameters and moments kept in their layouts across
the step).

* the reference: compiled in a subprocess on 8 host devices (``XLA_FLAGS``
  set there only) on a mesh built from ``jax.devices()``, its collectives
  counted by ``repro.launch.hloparse.parse_collectives`` (looped bytes);
* the port: the same step on a fake 8-rank meta mesh, counted by
  ``launch/commcount.CollectiveCounter``.

Prints each one's bytes a device by kind, and each package's baseline ÷
opt total.  Counts from shapes; nothing is run on a device.  The reference's
own dry run cannot compile a production cell on this JAX, so this is how a
hillclimbed ratio is held against the reference.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# builds ``cfg`` in either package; PKG is "repro" or "repro_torch"
_CFG = textwrap.dedent("""
    import dataclasses
    from PKG.configs import get_arch, smoke_config
    from PKG.launch.optconfig import OPT_OVERRIDES

    def small_cfg(arch, kind, opt, repeats, pods):
        over = dict(OPT_OVERRIDES.get(arch, {})) if opt else {}
        group_axis = over.pop("moe_group_axis", None)
        expert_axis = over.pop("moe_expert_axis", None)
        if kind != "train":
            over.pop("layout", None)
            over.pop("fsdp", None)
        if repeats:
            n = len(get_arch(arch).pattern) * repeats
            cfg = get_arch(arch, tp=2, n_layers=n, **over)
        else:
            cfg = smoke_config(arch, tp=2, **over)
        every = cfg.layout in ("dp", "fsdp2d")
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, dispatch_groups=8 if every else 4,
                group_axis=group_axis, expert_axis=expert_axis))
        axes = ("pod", "data") if pods > 1 else ("data",)
        return cfg.replace(batch_axes=axes + ("model",) if every else axes)
""")

_REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.launch.hloparse import parse_collectives
    from repro.models import transformer as T
    from repro.optim import AdamWConfig, adamw_init
    from repro.parallel import batch_specs, param_specs, zero1_specs
    from repro.train import make_train_step
    """) + _CFG.replace("PKG", "repro") + textwrap.dedent("""
    arch, kind, rows, seq, mb, repeats, pods = json.loads(sys.argv[1])
    msd = {"pod": pods, "data": 4 // pods, "model": 2}
    mesh = Mesh(np.array(jax.devices()).reshape(pods, 4 // pods, 2),
                ("pod", "data", "model"))

    def ns(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    out = {}
    for opt in (False, True):
        cfg = small_cfg(arch, kind, opt, repeats, pods)
        params = jax.eval_shape(lambda: T.init_params(
            cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
        ps = param_specs(cfg, params, msd)
        with mesh:
            if kind == "prefill":
                b = {"tokens": jax.ShapeDtypeStruct((rows, seq), jnp.int32)}
                fn = lambda p, bb: T.prefill(p, cfg, bb, seq,
                                             dtype=jnp.bfloat16)
                lowered = jax.jit(fn, in_shardings=(
                    ns(ps), ns(batch_specs(cfg, b, msd)))).lower(params, b)
            else:
                oc = AdamWConfig(moment_dtype=cfg.opt_dtype)
                o = jax.eval_shape(lambda p: adamw_init(p, oc), params)
                axes = ("data", "model") if cfg.layout in ("dp", "fsdp2d") \\
                    else ("data",)
                zs = zero1_specs(ps, params, msd, axes=axes)
                b = {k: jax.ShapeDtypeStruct((rows, seq), jnp.int32)
                     for k in ("tokens", "labels")}
                ins = (ns(ps), ns({"m": zs, "v": zs, "step": P()}),
                       ns(batch_specs(cfg, b, msd)))
                lowered = jax.jit(make_train_step(cfg, oc,
                                                  num_microbatches=mb),
                                  in_shardings=ins,
                                  out_shardings=(ins[0], ins[1], None)
                                  ).lower(params, o, b)
            hlo = lowered.compile().as_text()
        out["opt" if opt else "base"] = parse_collectives(hlo)["looped"]
    print(json.dumps(out))
""")


def reference(arch: str, kind: str, rows: int, seq: int, mb: int,
              repeats: int, pods: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _REF,
         json.dumps([arch, kind, rows, seq, mb, repeats, pods])],
        env=env, capture_output=True, text=True, timeout=3000)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def port(arch: str, kind: str, rows: int, seq: int, mb: int,
         repeats: int, pods: int) -> dict:
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.commcount import CollectiveCounter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import (batch_specs, distribute_tree,
                                      param_specs, zero1_specs)
    from repro_torch.parallel.sharding import P
    from repro_torch.train import make_train_step
    scope: dict = {}
    exec(_CFG.replace("PKG", "repro_torch"), scope)
    out = {}
    msd = {"pod": pods, "data": 4 // pods, "model": 2}
    for opt in (False, True):
        cfg = scope["small_cfg"](arch, kind, opt, repeats, pods)
        with dryrun.fake_world(8):
            mesh = make_mesh(msd, "cuda")
            params = T.init_params(cfg, device="meta", dtype=torch.bfloat16)
            ps = param_specs(cfg, params, msd)
            dparams = distribute_tree(params, ps, mesh)
            names = ("tokens",) if kind == "prefill" else ("tokens",
                                                            "labels")
            b = {k: torch.empty((rows, seq), dtype=torch.int32,
                                device="meta") for k in names}
            db = distribute_tree(b, batch_specs(cfg, b, msd), mesh)
            if kind == "prefill":
                with CollectiveCounter() as counter:
                    T.prefill(dparams, cfg, db, seq, dtype=torch.bfloat16)
            else:
                oc = AdamWConfig(moment_dtype=cfg.opt_dtype)
                axes = ("data", "model") if cfg.layout in ("dp", "fsdp2d") \
                    else ("data",)
                zs = zero1_specs(ps, params, msd, axes=axes)
                dopt = distribute_tree(adamw_init(params, oc),
                                       {"m": zs, "v": zs, "step": P()}, mesh)
                with CollectiveCounter() as counter:
                    make_train_step(cfg, oc, num_microbatches=mb)(
                        dparams, dopt, db)
        out["opt" if opt else "base"] = counter.result()["looped"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("kind", choices=("train", "prefill"))
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--port-only", action="store_true",
                    help="the port's half alone (a machine without JAX)")
    ap.add_argument("--pods", type=int, default=1, choices=(1, 2),
                    help="2: (pod 2, data 2, model 2), the multi-pod "
                         "mesh's shape")
    ap.add_argument("--repeats", type=int, default=0,
                    help="the arch's own widths, this many repeats of its "
                         "layer pattern (0: smoke_config's widths)")
    a = ap.parse_args(argv)
    key = (a.arch, a.kind, a.rows, a.seq, a.microbatches, a.repeats, a.pods)
    print(f"{a.arch} {a.kind}: {a.rows} x {a.seq} tokens, "
          f"{a.microbatches} microbatch(es), "
          f"{'smoke widths' if not a.repeats else f'{a.repeats} repeat(s)'}"
          f", {'(pod 2, data 2' if a.pods == 2 else '(data 4'}, model 2), "
          "bytes a device")
    runs = [("port", port)] if a.port_only else [("reference HLO", reference),
                                                 ("port", port)]
    for name, run in runs:
        res = run(*key)
        for v in ("base", "opt"):
            kinds = {k: n for k, n in res[v].items() if n and k != "total"}
            print(f"  {name:13s} {v:4s} total {res[v]['total']:>12,} "
                  f"{json.dumps(kinds)}")
        ratio = res["base"]["total"] / max(res["opt"]["total"], 1)
        print(f"  {name:13s} baseline / opt {ratio:.3f}x")


if __name__ == "__main__":
    main()
