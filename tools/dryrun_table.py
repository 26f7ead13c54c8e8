"""The port's dry-run records as a Markdown table, beside the reference's
analytic counts.

    PYTHONPATH=src:. python tools/dryrun_table.py [--dir results/dryrun_torch]

Reads the JSON records ``python -m repro_torch.launch.dryrun --all
--both-meshes`` writes, one row a (arch, shape) with both meshes: each
cell's status and ``trace_s``, its ``flops_per_device`` and the ratio of it
to ``benchmarks/counts.py:cell_counts(...).flops_per_device`` (the
reference's analytic count for the same config, shape, mesh and
microbatches; reported, not asserted), its collective bytes a device by
kind, and ``argument_bytes + temp_bytes`` as a share of an H100's 80 GB.
All of it is counted from shapes; nothing here is a time on a device.
The reference's records are never read.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from benchmarks.counts import cell_counts
from repro.configs import ARCH_IDS, SHAPES
from repro.launch.optconfig import build_cfg

MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
HBM = 80e9
KINDS = (("all-reduce", "AR"), ("all-gather", "AG"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def _cell(rec: dict) -> str:
    """One mesh's part of a row."""
    if rec is None:
        return "missing | | | |"
    if rec["status"] == "skipped":
        return "skipped | | | |"
    if rec["status"] != "ok":
        return f"**{rec['status']}** | | | |"
    mesh = MESHES[rec["mesh"]]
    cell = SHAPES[rec["shape"]]
    cfg = build_cfg(rec["arch"], mesh, kind=cell.kind)
    ref = cell_counts(cfg, cell, mesh,
                      microbatches=rec["microbatches"]).flops_per_device
    coll = rec["collective_bytes_per_device"]
    kinds = " ".join(f"{short} {coll[k] / 1e9:.3g}" for k, short in KINDS
                     if coll[k])
    mem = rec["memory"]
    held = mem["argument_bytes"] + mem["temp_bytes"]
    return (f"ok {rec['trace_s']} s | {rec['flops_per_device']:.4g} "
            f"({rec['flops_per_device'] / ref:.3f}) | {kinds or '0'} | "
            f"{held / 1e9:.4g} ({100 * held / HBM:.0f}%)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    recs = {}
    for path in Path(args.dir).glob("*.json"):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    print("| arch | shape | single pod: status, trace | FLOP a device "
          "(÷ counts.py) | collective GB a device | argument + temp GB "
          "(of 80) | multi-pod: status, trace | FLOP (÷ counts.py) | "
          "collective GB | argument + temp GB |")
    print("|---" * 10 + "|")
    skipped = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in MESHES]
            if all(r is not None and r["status"] == "skipped"
                   for r in pair):
                skipped.append(arch)
                continue
            print(f"| {arch} | {shape} | " + " | ".join(
                _cell(r) for r in pair) + " |")
    n = {s: sum(r["status"] == s for r in recs.values())
         for s in ("ok", "skipped", "failed")}
    print(f"\nlong_500k skipped on both meshes (the reference's skip): "
          f"{', '.join(skipped)}.  Records: {len(recs)}; {n}.")


if __name__ == "__main__":
    main()
