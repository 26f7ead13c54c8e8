"""The port's dry-run records as a Markdown table, beside the reference's
analytic counts.

    PYTHONPATH=src:. python tools/dryrun_table.py [--dir results/dryrun_torch]
    PYTHONPATH=src:. python tools/dryrun_table.py --dir results/dryrun_torch_opt \
        --base results/dryrun_torch

Reads the JSON records ``python -m repro_torch.launch.dryrun --all
--both-meshes`` writes, one row a (arch, shape) with both meshes: each
cell's status and ``trace_s``, its ``flops_per_device`` and the ratio of it
to ``benchmarks/counts.py:cell_counts(...).flops_per_device`` (the
reference's analytic count for the same config, shape, mesh and
microbatches; reported, not asserted), its collective bytes a device by
kind, and ``argument_bytes + temp_bytes`` as a share of an H100's 80 GB.
With ``--base`` (the baseline grid's records; ``--dir`` then holds the
``--opt`` grid's), it also prints the four hillclimbed cells' baseline ÷
opt collective totals beside the reference's bars
(``tests/test_dryrun_results.py:test_hillclimbed_cells_improved``), and
each cell of both grids side by side.  With ``--moved-from OLD`` it
prints only the cells whose counts differ from OLD's records.
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
# the reference's hillclimbed cells and their bars, baseline ÷ opt
# collective bytes a device (tests/test_dryrun_results.py)
HILLCLIMBED = (("single_pod", "jamba-1.5-large-398b", "train_4k", 2.0),
               ("single_pod", "qwen1.5-32b", "train_4k", 4.0),
               ("single_pod", "olmo-1b", "train_4k", 8.0),
               ("single_pod", "mixtral-8x7b", "prefill_32k", 20.0))
KINDS = (("all-reduce", "AR"), ("all-gather", "AG"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def _counts_flops(rec: dict) -> float:
    """``benchmarks/counts.py``'s FLOPs a device for the record's cell."""
    mesh = MESHES[rec["mesh"]]
    cell = SHAPES[rec["shape"]]
    cfg = build_cfg(rec["arch"], mesh, kind=cell.kind,
                    opt=rec.get("opt", False))
    return cell_counts(cfg, cell, mesh,
                       microbatches=rec["microbatches"]).flops_per_device


def _cell(rec: dict) -> str:
    """One mesh's part of a row."""
    if rec is None:
        return "missing | | | |"
    if rec["status"] == "skipped":
        return "skipped | | | |"
    if rec["status"] != "ok":
        return f"**{rec['status']}** | | | |"
    ref = _counts_flops(rec)
    coll = rec["collective_bytes_per_device"]
    kinds = " ".join(f"{short} {coll[k] / 1e9:.3g}" for k, short in KINDS
                     if coll[k])
    mem = rec["memory"]
    held = mem["argument_bytes"] + mem["temp_bytes"]
    return (f"ok {rec['trace_s']} s | {rec['flops_per_device']:.4g} "
            f"({rec['flops_per_device'] / ref:.3f}) | {kinds or '0'} | "
            f"{held / 1e9:.4g} ({100 * held / HBM:.0f}%)")


def _load(d: str) -> dict:
    recs = {}
    for path in Path(d).glob("*.json"):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return recs


def _total(rec) -> float | None:
    if rec is None or rec["status"] != "ok":
        return None
    return rec["collective_bytes_per_device"]["total"]


def _brief(rec) -> str:
    """A record's trace wall, FLOPs ÷ counts.py's, collective GB a device
    by kind and argument + temp GB."""
    if rec is None:
        return "missing"
    if rec["status"] != "ok":
        return rec["status"]
    coll = rec["collective_bytes_per_device"]
    kinds = " ".join(f"{short} {coll[k] / 1e9:.3g}" for k, short in KINDS
                     if coll[k])
    mem = rec["memory"]
    return (f"{rec['trace_s']} s, "
            f"{rec['flops_per_device'] / _counts_flops(rec):.3f}× · "
            f"{kinds or '0'} · "
            f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.4g}")


def ratios(base: dict, opt: dict) -> None:
    """Baseline ÷ opt collective bytes a device: the hillclimbed cells
    beside their bars, then every (arch, shape) with both grids' records
    by mesh (trace wall, FLOPs ÷ counts.py's · collective GB by kind ·
    argument + temp GB) and the ratio."""
    print("| cell | baseline GB | opt GB | baseline ÷ opt | reference's bar |")
    print("|---" * 5 + "|")
    for mesh, arch, shape, bar in HILLCLIMBED:
        b, o = (_total(r.get((arch, shape, mesh))) for r in (base, opt))
        x = f"{b / max(o, 1):.3f}×" if b is not None and o is not None \
            else "missing"
        gb = ["missing" if t is None else f"{t / 1e9:.6g}" for t in (b, o)]
        print(f"| {arch} `{shape}` {mesh} | {gb[0]} | {gb[1]} | {x} | "
              f"≥ {bar:g}× |")
    print("\n| arch | shape | single pod: baseline | opt | ÷ | multi-pod: "
          "baseline | opt | ÷ |")
    print("|---" * 8 + "|")
    for arch in ARCH_IDS:
        for shape in SHAPES:
            parts = []
            for mesh in MESHES:
                rb, ro = base.get((arch, shape, mesh)), opt.get(
                    (arch, shape, mesh))
                b, o = _total(rb), _total(ro)
                parts += [_brief(rb), _brief(ro),
                          f"{b / max(o, 1):.3f}×" if b is not None
                          and o is not None else "—"]
            if any(p != "skipped" for p in parts[:2] + parts[3:5]):
                print(f"| {arch} | {shape} | " + " | ".join(parts) + " |")


def moved(old: dict, new: dict) -> None:
    """The cells whose FLOPs, memory or collective bytes differ between two
    grids' records (the same layouts, another tree or torch)."""
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key), new.get(key)
        if a is None or b is None or a["status"] != b["status"]:
            print(f"{key}: {a and a['status']} -> {b and b['status']}")
            continue
        if a["status"] != "ok":
            continue
        diffs = []
        for name, get in (
                ("flops", lambda r: r["flops_per_device"]),
                ("argument", lambda r: r["memory"]["argument_bytes"]),
                ("temp", lambda r: r["memory"]["temp_bytes"]),
                *((k, lambda r, k=k: r["collective_bytes_per_device"][k])
                  for k in ("all-reduce", "all-gather", "reduce-scatter",
                            "all-to-all", "total"))):
            if get(a) != get(b):
                diffs.append(f"{name} {get(a):.12g} -> {get(b):.12g}")
        if diffs:
            print(f"{'/'.join(key)}: " + "; ".join(diffs))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--base", default=None,
                    help="the baseline grid's records, for the ratios")
    ap.add_argument("--moved-from", default=None,
                    help="an older grid's records of the same layouts: "
                         "print only the cells whose counts differ")
    args = ap.parse_args(argv)
    recs = _load(args.dir)
    if args.moved_from:
        moved(_load(args.moved_from), recs)
        return
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
    if args.base:
        print()
        ratios(_load(args.base), recs)


if __name__ == "__main__":
    main()
