"""One dry-run cell's FLOPs a device, op by op: where the port's count and
``benchmarks/counts.py``'s part.

    PYTHONPATH=src python tools/dryrun_breakdown.py ARCH SHAPE [--multi-pod]
        [--microbatches M]

Traces the cell as ``python -m repro_torch.launch.dryrun`` does (meta
DTensors on the 256- or 512-rank fake mesh) and prints, for every op that
``torch.utils.flop_counter`` counts, its FLOPs a device and its largest
shapes (the local operands), the SSD's meta count, and the ops that are
not counted, by the elements they write.  Then ``benchmarks/counts.py``'s
count of the same cell a device, term by term (``counts_terms``, its
``_fwd_flops_global`` split into terms; their sum is checked against
``cell_counts`` where ``benchmarks`` imports, as with ``PYTHONPATH=src:.``
beside the reference).  Counted from shapes; nothing here is a time.
"""
from __future__ import annotations

import argparse
import collections
import math
import time

import torch

from repro_torch.configs import SHAPES
from repro_torch.kernels import ssd_scan
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.launch.optconfig import microbatches_for
from repro_torch.models.attention import AttnDims


class _ByOp(D._CellCost):
    """``dryrun``'s counter, with each counted op's FLOPs kept by op and by
    operand shapes, and each uncounted op's output elements."""

    def __init__(self, args):
        super().__init__(args)
        self.by_op = collections.Counter()
        self.by_shape = collections.defaultdict(collections.Counter)
        self.uncounted = collections.Counter()

    def local_op(self, func, args, kwargs, out) -> None:
        before = self.flops
        super().local_op(func, args, kwargs, out)
        name = str(func.overloadpacket)
        if self.flops != before:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            self.by_op[name] += self.flops - before
            self.by_shape[name][shapes] += self.flops - before
            return
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.uncounted[name] += sum(o.numel() for o in outs
                                    if isinstance(o, torch.Tensor))


def counts_terms(cfg, cell, n_devices: int) -> dict:
    """``benchmarks/counts.py:cell_counts(...).flops_per_device`` by term:
    its ``_fwd_flops_global`` (``counts.py:54-99``), term by term, times
    its train factor (4 with remat, else 3), over the devices."""
    d, dh = cfg.d_model, cfg.d_head
    t = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    kv = cell.seq_len
    dims = AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                    tp=cfg.tp)
    hq, hkv = dims.n_q_phys, dims.n_kv_phys
    all_pairs = cfg.attn_impl_train != "wedge"
    n_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    terms = collections.Counter()
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            terms["attention projections"] += \
                2.0 * t * d * dh * (hq + 2 * hkv) + 2.0 * t * hq * dh * d
            if cell.kind == "decode":
                eff = min(kv, cfg.swa_window) if cfg.swa_window else kv
            elif cfg.swa_window:
                eff = min(cfg.swa_window + cfg.attn_chunk_k, kv) \
                    if all_pairs else min(cfg.swa_window, kv)
            else:
                eff = kv if all_pairs else kv / 2
            terms["attention scores"] += 4.0 * t * hq * dh * eff
        else:
            s = cfg.ssm
            terms["ssm in-projection B/C"] += 2.0 * t * d * s.d_bc
            terms["ssm other projections"] += \
                2.0 * t * d * (2 * s.d_inner + s.n_heads) \
                + 2.0 * t * s.d_inner * d
            terms["ssm conv"] += 2.0 * t * s.d_conv * (s.d_inner + s.d_bc)
            h, p, n, q = s.n_heads, s.head_dim, s.d_state, s.chunk
            terms["ssd"] += t * h * 4.0 * p * n if cell.kind == "decode" \
                else t * (h * (2.0 * q * p + 4.0 * p * n)
                          + s.n_groups * 2.0 * q * n)
        if spec.ffn == "dense":
            terms["mlp"] += 2.0 * n_mats * d * cfg.d_ff * t
        elif spec.ffn == "moe":
            m = cfg.moe
            g = max(m.dispatch_groups, 1)
            gs = max(t // g, 1)
            c = int(math.ceil(gs * m.top_k * m.capacity_factor
                              / m.n_experts))
            cap = max(8, -(-c // 8) * 8)
            terms["moe experts"] += \
                2.0 * n_mats * d * m.d_ff_expert * g * m.n_experts * cap
            terms["moe router"] += 2.0 * t * d * m.n_experts
            if m.n_shared:
                ffs = m.d_ff_shared or m.n_shared * m.d_ff_expert
                terms["moe shared"] += 2.0 * n_mats * d * ffs * t
    terms = collections.Counter({k: v * cfg.n_repeats
                                 for k, v in terms.items()})
    terms["lm head"] = 2.0 * t * d * cfg.vocab * max(cfg.n_codebooks, 1)
    factor = (4.0 if cfg.remat else 3.0) if cell.kind == "train" else 1.0
    return {k: v * factor / n_devices for k, v in terms.items()}


def _check_counts(arch: str, shape: str, mesh_shape: dict, mb: int,
                  total: float) -> None:
    """Hold ``counts_terms``' sum against ``counts.py`` itself, where the
    reference imports."""
    try:
        from benchmarks.counts import cell_counts
        from repro.configs import SHAPES as R_SHAPES
        from repro.launch.optconfig import build_cfg
    except ImportError:
        print("counts.py not importable here: the sum is not checked")
        return
    cell = R_SHAPES[shape]
    want = cell_counts(build_cfg(arch, mesh_shape, kind=cell.kind), cell,
                       mesh_shape, microbatches=mb).flops_per_device
    print(f"counts.py's cell_counts: {want:.6e} (terms sum to {total:.6e})")
    assert math.isclose(total, want, rel_tol=1e-9), (total, want)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)
    cell = SHAPES[args.shape]
    mb = args.microbatches if args.microbatches is not None else \
        microbatches_for(args.arch, cell.kind, False)
    with D.fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cuda")
        cfg = D.dryrun_cfg(args.arch, mesh, kind=cell.kind)
        fn, fargs = D._trace_cell(cfg, cell, mesh, microbatches=mb)
        ssd_scan.reset_meta_flops()
        t0 = time.perf_counter()
        with _ByOp(fargs) as cost:
            fn(*fargs)
        trace_s = time.perf_counter() - t0
        n_devices = mesh.size()
        mesh_shape = mesh_shape_dict(mesh)
    total = cost.flops + sum(ssd_scan.META_FLOPS.values())
    print(f"{args.arch} {args.shape} "
          f"{'multi' if args.multi_pod else 'single'}-pod, {mb} "
          f"microbatch(es), torch {torch.__version__}, trace {trace_s:.1f} s")
    print(f"FLOP a device {total:.6e}; SSD meta count "
          + ", ".join(f"{k} {v:.6e}" for k, v in ssd_scan.META_FLOPS.items()))
    for name, flops in cost.by_op.most_common():
        print(f"  {name:24s} {flops:.6e} ({flops / total:.4f})")
        for shapes, f in cost.by_shape[name].most_common(8):
            print(f"      {shapes} {f:.6e}")
    print("not counted (elements written):")
    for name, n in cost.uncounted.most_common(10):
        print(f"  {name:40s} {n:.3e}")
    terms = counts_terms(cfg, cell, n_devices)
    ref = sum(terms.values())
    print(f"counts.py a device {ref:.6e} (ratio {total / ref:.4f}), by term:")
    for name, flops in sorted(terms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {flops:.6e}")
    _check_counts(args.arch, args.shape, mesh_shape, mb, ref)


if __name__ == "__main__":
    main()
