"""Multi-pod dry run: trace every (architecture x shape x mesh) cell on a
256- or 512-rank fake mesh over meta DTensors.

The port of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell with pjit on 512 fake host devices and reads XLA's
per-device memory and cost analyses; torch compiles nothing, so here each
cell runs once, eagerly, in one process that stands in for every rank:

* the ``"fake"`` process group at 256 ranks ((16, 16) ("data", "model"))
  or 512 ((2, 16, 16) with "pod"), started here if none is running and
  destroyed after the cell;
* ``make_production_mesh(device_type="cuda")``: a cuda-typed fake mesh, so
  DTensor issues the all-to-alls NCCL would be asked for (on a cpu-typed
  mesh it replaces them with an all-gather and a chunk).  No card is used
  or needed: every tensor is a meta tensor, shapes and types only;
* the cell's meta parameters, ZeRO-1 moments (``zero1_specs`` over
  "data", and "model" too for the "dp"/"fsdp2d" layouts, the reference's
  rule), batches and caches from ``launch/specs.py``, laid out by
  ``parallel.distribute_tree``; then ``make_train_step(cfg, AdamWConfig(
  moment_dtype=cfg.opt_dtype), num_microbatches=mb)``, ``T.prefill(...,
  dtype=torch.bfloat16)`` or ``T.decode_step`` on the distributed cache,
  under the counters.

The counters (``_CellCost``, a ``commcount.CollectiveCounter``) see each
op a device runs on its shards, and not DTensor's propagation of each op
at its global shape (which would count, for one sharded product, the
whole product).  A record has the reference's keys where their meaning
carries over:

* ``collective_bytes_per_device``, ``collective_bytes_raw`` and
  ``collective_counts``: ``commcount``'s result (the bytes of each
  collective's result buffer on one device, every trip of every loop);
* ``flops_per_device``: the local ops' FLOPs by
  ``torch.utils.flop_counter``'s formulas (products, convolutions,
  attention), plus the SSD scan's meta calls by the count of its kernels'
  bounds (``kernels/ssd_scan.py``: forward 4 P N, backward
  ``flops_per_token_head``, 11.0625 P N at P = 64 and N = 128, a (token,
  head));
* ``bytes_accessed_per_device``: the sum of every local op's input and
  output bytes, views and uninitialised allocations left out.  The ops
  run eagerly and unfused, each reading and writing its whole operands, so
  this is an upper bound; XLA's ``bytes accessed`` is counted after
  fusion and is smaller;
* ``memory``: ``argument_bytes`` (the local shards of the arguments),
  ``output_bytes`` (of the results) and ``temp_bytes``, the peak of the
  local storage made during the call and still alive (the results
  included), above the arguments.  Nothing is compiled, so there is no
  ``generated_code_bytes``;
* ``trace_s`` (the call's wall) in place of ``lower_s``/``compile_s``.

These are counts from shapes; no number here was measured on any device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable
from repro_torch.configs.shapes import ShapeCell
from repro_torch.kernels import ssd_scan
from repro_torch.launch import specs as S
from repro_torch.launch.commcount import CollectiveCounter
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.launch.optconfig import build_cfg, microbatches_for
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import (batch_specs, cache_specs, distribute_tree,
                                  param_specs, zero1_specs)
from repro_torch.parallel.sharding import P
from repro_torch.train.loop import make_train_step

__all__ = ["dryrun_cfg", "run_cell", "main", "fake_world"]

SKIP_REASON = ("full-attention arch: long_500k needs sub-quadratic "
               "attention (DESIGN.md §4)")
_NO_ACCESS = {"aten.empty", "aten.empty_strided", "aten.empty_like",
              "aten.new_empty", "aten.new_empty_strided"}


def _tensors(tree) -> list:
    """The local tensors of ``tree`` (DTensors as their shards), each
    once."""
    out, seen = [], set()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _CellCost(CollectiveCounter):
    """Collectives (``CollectiveCounter``), and the local ops' FLOPs, bytes
    accessed and the peak of the storage they make, while it is on.
    ``args`` are the call's arguments: their storage is not counted as
    made."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._known = {id(t.untyped_storage()) for t in _tensors(args)}

    def _freed(self, key: int, nbytes: int) -> None:
        self._known.discard(key)
        self.live -= nbytes

    def local_op(self, func, args, kwargs, out) -> None:
        super().local_op(func, args, kwargs, out)
        packet = func.overloadpacket
        count = flop_registry.get(packet)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not getattr(func, "is_view", False) \
                and str(packet) not in _NO_ACCESS:
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            self._known.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key, n)


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """The ``"fake"`` process group of ``n_ranks`` ranks (this process is
    rank 0 and stands in for all), started if none is running and
    destroyed on exit; a running group of another size is refused."""
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is running; the mesh needs {n_ranks}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _trace_cell(cfg, cell: ShapeCell, mesh, *, microbatches: int = 1):
    """(fn, args) of one cell: ``fn(*args)`` runs it on meta DTensors laid
    out on ``mesh``."""
    msd = mesh_shape_dict(mesh)
    p_sds = S.params_shapes(cfg)
    p_spec = param_specs(cfg, p_sds, msd)
    params = distribute_tree(p_sds, p_spec, mesh)

    if cell.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype)
        o_sds = S.opt_shapes(cfg, opt_cfg, p_sds)
        z_axes = ("data", "model") if cfg.layout in ("dp", "fsdp2d") \
            else ("data",)
        o_spec = zero1_specs(p_spec, p_sds, msd, axes=z_axes)
        opt = distribute_tree(o_sds, {"m": o_spec, "v": o_spec, "step": P()},
                              mesh)
        b_sds = S.train_input_specs(cfg, cell)
        batch = distribute_tree(b_sds, batch_specs(cfg, b_sds, msd), mesh)
        step = make_train_step(cfg, opt_cfg, num_microbatches=microbatches)
        return step, (params, opt, batch)
    if cell.kind == "prefill":
        b_sds = S.prefill_input_specs(cfg, cell)
        batch = distribute_tree(b_sds, batch_specs(cfg, b_sds, msd), mesh)

        def fn(p, b):
            return T.prefill(p, cfg, b, cell.seq_len, dtype=torch.bfloat16)

        return fn, (params, batch)
    b_sds = S.decode_input_specs(cfg, cell)
    batch = distribute_tree(b_sds, batch_specs(cfg, b_sds, msd), mesh)
    c_sds = S.cache_shapes(cfg, cell)
    cache = distribute_tree(c_sds, cache_specs(cfg, c_sds, msd), mesh)

    def fn(p, b, c):
        return T.decode_step(p, cfg, b["tokens"], c)

    return fn, (params, batch, cache)


def dryrun_cfg(arch: str, mesh, *, opt: bool = False, kind: str = "train"):
    """Arch config specialized to the mesh (see launch/optconfig.py)."""
    return build_cfg(arch, mesh_shape_dict(mesh), opt=opt, kind=kind)


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             microbatches: int | None = None, verbose: bool = True,
             opt: bool = False) -> dict:
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
        cell = SHAPES[shape]
        cfg = dryrun_cfg(arch, mesh, opt=opt, kind=cell.kind)
        if not cell_applicable(cfg, cell):
            return {"arch": arch, "shape": shape, "mesh": mesh_name,
                    "status": "skipped", "reason": SKIP_REASON}
        mb = microbatches if microbatches is not None else \
            microbatches_for(arch, cell.kind, opt)
        fn, args = _trace_cell(cfg, cell, mesh, microbatches=mb)
        arg_bytes = _nbytes(args)
        ssd_scan.reset_meta_flops()
        t0 = time.perf_counter()
        with _CellCost(args) as cost:
            out = fn(*args)
        trace_s = time.perf_counter() - t0
        n_devices = mesh.size()
    coll = cost.result()
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "status": "ok",
        "kind": cell.kind,
        "microbatches": mb,
        "layout": cfg.layout,
        "opt": opt,
        "trace_s": round(trace_s, 1),
        "flops_per_device": float(cost.flops
                                  + sum(ssd_scan.META_FLOPS.values())),
        "bytes_accessed_per_device": float(cost.bytes_accessed),
        "collective_bytes_per_device": coll["looped"],
        "collective_bytes_raw": coll["raw"],
        "collective_counts": coll["counts"],
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": _nbytes(out),
                   "temp_bytes": cost.peak},
        "n_devices": n_devices,
    }
    if verbose:
        print(json.dumps(result, indent=None)[:400])
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--opt", action="store_true",
                    help="apply hillclimbed per-arch layouts (OPT_OVERRIDES)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in meshes:
                    cells.append((arch, shape, mp))
    else:
        cells.append((args.arch, args.shape, args.multi_pod))

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shape, mp in cells:
        tag = f"{'mp' if mp else 'sp'}_{arch}_{shape}"
        out_path = os.path.join(args.out, f"{tag}.json")
        if os.path.exists(out_path):
            with open(out_path) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped"):
                print(f"[cached] {tag}: {prev['status']}")
                n_ok += prev["status"] == "ok"
                n_skip += prev["status"] == "skipped"
                continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            res = run_cell(arch, shape, multi_pod=mp,
                           microbatches=args.microbatches, opt=args.opt)
            n_ok += res["status"] == "ok"
            n_skip += res["status"] == "skipped"
        except Exception as e:  # noqa: BLE001 — record and continue
            res = {"arch": arch, "shape": shape,
                   "mesh": "multi_pod" if mp else "single_pod",
                   "status": "failed", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            n_fail += 1
            print(f"[FAIL] {tag}: {e}")
        with open(out_path, "w") as f:
            json.dump(res, f, indent=2)
    print(f"\ndryrun summary: ok={n_ok} skipped={n_skip} failed={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
