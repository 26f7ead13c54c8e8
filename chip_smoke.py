#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. card: name, compute capability, torch/CUDA versions, power limit;
  2. build: nvcc builds every CUDA source of the port (in parallel);
  3. every kernel against its plain PyTorch version on the card, on edge
     cases (ragged and poisoned rows, odd shapes, mass past 2**24, ...):
     counts and mass must agree exactly;
  4. the main path at full size: token blocks -> sampled estimates (one
     block_stats_batched launch a chunk) -> DV-DVFS plans -> simulated run
     against the full-block truth, with every kernel's launch count read
     after it;
  5. the same path on a small dataset, card against CPU;
  6. the five apps on the card at the paper-figure block sizes, with the
     paper's estimate -> plan -> simulate comparison against DVO;
  7. kernel and plain times at the main path's shapes, beside the byte bound.

It ends with one JSON line of per-kernel numbers, the nvidia-smi name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line.  The
joules it prints come from the paper's power model in simulation; nothing
here measures the card's energy.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.apps import ALL_APPS, measure_block_seconds  # noqa: E402
from repro_torch.core import (CPU_PAPER_POWER, BlockInfo,  # noqa: E402
                              EstimateArrays, plan_dvfs, plan_dvo,
                              plan_dvo_arrays, simulate, variety_stats)
from repro_torch.data import BlockDataset  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import block_stats as bs  # noqa: E402
from repro_torch.pipeline import (PipelineConfig,  # noqa: E402
                                  plan_estimates, stream_estimates_tokens,
                                  token_chunk_estimates, token_cost)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
PATTERN = (17, 23, 5)
POWER = CPU_PAPER_POWER       # the paper's power model (formula 7)
SLACKS = (1.08, 1.20)         # tight and firm deadlines, benchmarks/paper_figs.py

# the main path: 1024 blocks of 2048 records x 256 tokens (2 GiB of int32),
# streamed 256 blocks (512 MiB) at a time
MAIN = dict(n_blocks=1024, records_per_block=2048, max_len=256, vocab=32768,
            variety_z=1.0, seed=0)
CHUNK = 256
FRACTION = 0.05

# per-app block sizes of the paper figures (copied from
# benchmarks/paper_figs.py:46-57), 12 blocks each
APP_BLOCKS = {
    "wordcount": dict(records_per_block=16384, max_len=128, with_tokens=True),
    "grep": dict(records_per_block=32768, max_len=128, with_tokens=True),
    "inverted_index": dict(records_per_block=1024, max_len=128,
                           with_tokens=True),
    "avg": dict(records_per_block=1 << 21, max_len=8, with_tokens=False),
    "sum": dict(records_per_block=1 << 21, max_len=8, with_tokens=False),
}
APP_KEYS = {
    "wordcount": ("tokens",), "grep": ("tokens",), "inverted_index": ("tokens",),
    "avg": ("values", "group", "select"), "sum": ("values", "group", "select"),
}
APP_N_BLOCKS = 12

KERNELS = {
    "block_stats_batched": "src/repro/kernels/block_stats.py:104",
    "block_stats": "src/repro/kernels/block_stats.py:62",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync_seconds(fn):
    """(result, seconds) of ``fn()`` up to a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_card() -> tuple:
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    print(f"card: {name} | cc {cc[0]}.{cc[1]} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | nvidia-smi: {smi}")
    check(cc == (9, 0), f"the kernels are built for sm_90a, card is cc {cc}")
    return name, smi


def phase_build() -> None:
    for built in _build.build(bs.SOURCE):
        print(f"build: {built.seconds:.3f} s nvcc {' '.join(_build.NVCC_FLAGS)}"
              f" -> {built.path.relative_to(_build.BUILD_ROOT.parents[1])}")
        for line in built.log.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"ptxas: {line.strip()}")


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0


def compare_both_entries(label: str, toks: torch.Tensor, lengths, pattern,
                         exact_mass=None) -> dict:
    """Kernel vs plain on the card for both entries; exact agreement."""
    before = dict(bs.LAUNCHES)
    got = bs.block_stats_batched_cuda(toks, lengths, pattern)
    want = ref.block_stats_batched_ref(toks, lengths, pattern)
    err = {"block_stats_batched": _max_err(got, want)}
    check(err["block_stats_batched"] == 0.0,
          f"{label}: block_stats_batched differs from the plain version by "
          f"{err['block_stats_batched']}")
    if exact_mass is not None:
        check(np.array_equal(got[:, 2].cpu().numpy(), exact_mass),
              f"{label}: mass is not the exact int64 sum cast to float32")
    errs = []
    for b in range(toks.shape[0]):
        n = toks.shape[1] if lengths is None else \
            int(min(max(int(lengths[b]), 0), toks.shape[1]))
        one = bs.block_stats_cuda(toks[b, :n], pattern)
        errs.append(_max_err(one, ref.block_stats_ref(toks[b, :n], pattern)))
        errs.append(_max_err(one, got[b]))
    err["block_stats"] = max(errs, default=0.0)
    check(err["block_stats"] == 0.0,
          f"{label}: block_stats differs by {err['block_stats']}")
    nonempty = toks.numel() > 0
    check(bs.LAUNCHES["block_stats_batched"]
          == before["block_stats_batched"] + nonempty,
          f"{label}: block_stats_batched launch count")
    torch.cuda.synchronize()
    return err


def phase_parity() -> dict:
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in KERNELS}

    def case(label, toks, lengths=None, pattern=PATTERN, exact_mass=None):
        t = torch.as_tensor(toks, device=dev) if isinstance(toks, np.ndarray) \
            else toks
        err = compare_both_entries(label, t, lengths, pattern, exact_mass)
        for name, e in err.items():
            worst[name] = max(worst[name], e)
        print(f"parity ok: {label} {tuple(t.shape)}")

    toks = rng.integers(0, 50, (12, 300, 40)).astype(np.int32)
    lens = rng.integers(1, 301, 12)
    for b in range(12):
        toks[b, 0, :3] = PATTERN
        toks[b, lens[b]:, :3] = PATTERN          # poison the rows past length
    case("ragged lengths, poisoned pad rows", toks, lens)
    case("lengths=None", rng.integers(0, 50, (6, 64, 32)).astype(np.int32))
    one = rng.integers(0, 50, (1, 257, 48)).astype(np.int32)
    one[0, ::3, 5:8] = PATTERN
    case("n_blocks=1", one)
    case("R < tile", rng.integers(0, 50, (4, 3, 24)).astype(np.int32))
    case("L < p", np.full((3, 8, 2), 17, np.int32))
    short = rng.integers(0, 50, (5, 40, 16)).astype(np.int32)
    short[:, :, :3] = PATTERN
    case("lengths 0, above R and negative", short,
         np.array([0, 41, -3, 40, 7]))
    big = rng.integers(0, 32768, (4, 2048, 256)).astype(np.int32)
    exact = big.astype(np.int64).sum(axis=(1, 2)).astype(np.float32)
    check(bool(exact.min() > 2 ** 24), "mass case does not pass 2**24")
    case("ids to 32767, mass past 2**24", big, exact_mass=exact)
    base = torch.as_tensor(rng.integers(0, 30, (20, 33, 5)).astype(np.int32),
                           device=dev)
    view = base.permute(2, 1, 0)
    check(not view.is_contiguous(), "non-contiguous case is contiguous")
    case("non-contiguous", view, np.array([33, 10, 0, 5, 33]), (3, 4))
    overlap = np.full((2, 16, 30), 7, np.int32)
    overlap[1, ::2] = 0
    case("overlapping pattern", overlap, None, (7, 7))
    long_pat = tuple(range(1, 41))
    lp = rng.integers(0, 4, (3, 50, 64)).astype(np.int32)
    lp[:, ::3, 10:50] = long_pat
    case("40-token pattern", lp, np.array([50, 25, 1]), long_pat)

    before = dict(bs.LAUNCHES)
    for shape in ((0, 8, 8), (3, 0, 8), (2, 4, 0)):
        z = bs.block_stats_batched_cuda(
            torch.zeros(shape, dtype=torch.int32, device=dev))
        check(z.shape == (shape[0], 3) and not bool(z.any()),
              f"empty input {shape} does not give zeros")
    z1 = bs.block_stats_cuda(torch.zeros((0, 8), dtype=torch.int32,
                                         device=dev))
    check(z1.shape == (3,) and not bool(z1.any()), "empty single block")
    check(bs.LAUNCHES == before, "empty input launched a kernel")
    print("parity ok: empty inputs return zeros without a launch")
    return worst


def phase_main_path() -> dict:
    ds = BlockDataset(**MAIN)
    cfg = PipelineConfig(fraction=FRACTION, power=POWER)
    walls = dict.fromkeys(("generate", "estimate", "truth_stats", "plan"), 0.0)
    parts, truth = [], []
    first_chunk = None
    bs.reset_launches()
    t_all = time.perf_counter()
    chunks = ds.iter_token_chunks(CHUNK, device="cuda")
    while True:
        item, dt = sync_seconds(lambda: next(chunks, None))
        walls["generate"] += dt
        if item is None:
            break
        start, toks = item
        est, dt = sync_seconds(lambda: token_chunk_estimates(
            toks, start_index=start, config=cfg, device="cuda"))
        walls["estimate"] += dt
        parts.append(est)

        def full_stats():
            stats = ops.block_stats_batched(toks, None, ds.grep_pattern,
                                            device="cuda")
            # one block again through the single-block entry, the per-block
            # cross-check the reference's benchmark makes
            probe = ops.block_stats(toks[0], ds.grep_pattern, device="cuda")
            check(torch.equal(probe, stats[0]),
                  f"block {start}: block_stats != block_stats_batched row")
            return token_cost(stats).cpu().numpy()
        tr, dt = sync_seconds(full_stats)
        walls["truth_stats"] += dt
        truth.append(tr)
        if first_chunk is None:
            first_chunk = toks
    est = EstimateArrays.concat(parts)
    truth = np.concatenate(truth)
    check(len(est) == MAIN["n_blocks"] and len(truth) == MAIN["n_blocks"],
          "main path lost blocks")
    check(bool(np.isfinite(est.total).all() and (est.total > 0).all()),
          "estimates are not finite and positive")
    check(bool(np.all(est.ci_low <= est.total)
               and np.all(est.total <= est.ci_high)), "CI does not hold total")
    k = int(est.n_sampled[0])
    ratio = float(est.total.sum() / truth.sum())
    print(f"main path: {MAIN['n_blocks']} blocks x {MAIN['records_per_block']}"
          f" records x {MAIN['max_len']} tokens in chunks of {CHUNK}; sampled "
          f"k={k} rows a block; sum(estimates)/sum(truth) = {ratio:.6f}")
    check(0.9 < ratio < 1.1, f"estimates off the truth by {ratio}")

    t0 = time.perf_counter()
    truth_blocks = [BlockInfo(int(i), float(t))
                    for i, t in zip(est.index, truth)]
    plans = []
    for slack in SLACKS:
        deadline = slack * float(truth.sum())
        dvo = simulate(plan_dvo(truth_blocks, deadline, power=POWER),
                       truth_blocks, power=POWER)
        for planner in ("paper", "global", "dvo"):
            if planner == "dvo":
                pa = plan_dvo_arrays(est.to_block_arrays(), deadline,
                                     power=POWER)
            else:
                pa = plan_estimates(est, deadline, PipelineConfig(
                    planner=planner, power=POWER))
            rep = simulate(pa.to_schedule_plan(), truth_blocks, power=POWER)
            plans.append((slack, planner, rep))
            print(f"  deadline {slack:.2f}x truth {planner:6s}: "
                  f"{rep.total_energy_j:.6f} J simulated, paper power model "
                  f"({100 * rep.improvement_vs(dvo):+.4f}% vs DVO), time "
                  f"{rep.total_time_s:.6f} s of {deadline:.6f} s, "
                  f"deadline_met={rep.deadline_met}")
    walls["plan"] = time.perf_counter() - t0
    launches = dict(bs.LAUNCHES)
    print(f"  launches in the main path: {json.dumps(launches)}")
    for slack, planner, rep in plans:
        if slack == SLACKS[-1] and planner in ("paper", "global"):
            check(rep.deadline_met, f"{planner} misses the firm deadline")
    for name in KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")
    walls["total"] = time.perf_counter() - t_all
    print("  wall: " + ", ".join(f"{k} {v:.6f} s" for k, v in walls.items()))
    return {"launches": launches, "k": k, "first_chunk": first_chunk}


def phase_small_path() -> None:
    ds = BlockDataset(n_blocks=6, records_per_block=512, max_len=128, seed=3)
    cfg = PipelineConfig(fraction=FRACTION, power=POWER)
    card = stream_estimates_tokens(ds.iter_token_chunks(4, device="cuda"),
                                   cfg, device="cuda")
    cpu = stream_estimates_tokens(ds.iter_token_chunks(4, device="cpu"),
                                  cfg, device="cpu")
    check(np.array_equal(card.index, cpu.index)
          and np.array_equal(card.n_sampled, cpu.n_sampled),
          "card and CPU sample different rows")
    for key in ("total", "ci_low", "ci_high"):
        a, b = getattr(card, key), getattr(cpu, key)
        check(bool(np.allclose(a, b, rtol=1e-6, atol=0.0)),
              f"card and CPU {key} differ: {a} vs {b}")
    for planner in ("paper", "global"):
        for slack in SLACKS:
            deadline = slack * float(cpu.total.sum())
            pc = PipelineConfig(planner=planner, power=POWER)
            check(np.array_equal(plan_estimates(card, deadline, pc).rel_freq,
                                 plan_estimates(cpu, deadline, pc).rel_freq),
                  f"card and CPU {planner} plans differ at {slack}x")
    sc, sp = ds.stats_soa(4, device="cuda"), ds.stats_soa(4, device="cpu")
    check(all(np.array_equal(sc[key], sp[key]) for key in sc),
          "card and CPU stats_soa differ")
    print(f"small path on {ds.n_blocks} blocks: card == CPU (estimates within "
          "rtol 1e-6, sampled rows, stats, plan frequencies)")


def _app_outputs_agree(name, app, blk) -> None:
    card = app.run(blk, device="cuda")
    cpu = app.run(blk, device="cpu")
    if not isinstance(card, dict):
        card, cpu = {"out": card}, {"out": cpu}
    for key in card:
        a, b = card[key].cpu().numpy(), cpu[key].numpy()
        ok = np.allclose(a, b, rtol=1e-5, atol=0.0) if name in ("avg", "sum") \
            else np.array_equal(a, b)
        check(bool(ok), f"{name}.{key}: card and CPU differ")


def phase_apps() -> dict:
    rows = {}
    for name, sizes in APP_BLOCKS.items():
        kw = dict(sizes)
        with_tokens = kw.pop("with_tokens")
        ds = BlockDataset(n_blocks=APP_N_BLOCKS, variety_z=1.0, seed=0, **kw)
        app = ALL_APPS[name]()
        rng = np.random.default_rng(0)
        n = ds.records_per_block
        k = max(64, int(round(FRACTION * n)))
        times, t_sub = [], []
        t_gen = 0.0
        for i in range(ds.n_blocks):
            t0 = time.perf_counter()
            b = ds.block(i, with_tokens=with_tokens)
            t_gen += time.perf_counter() - t0
            blk = {key: b[key] for key in APP_KEYS[name]}
            if i == 0:
                _app_outputs_agree(name, app, blk)
            times.append(measure_block_seconds(app, blk, device="cuda"))
            rows_k = np.sort(rng.choice(n, size=k, replace=False))
            sub = {key: v[rows_k] for key, v in blk.items()}
            t_sub.append(measure_block_seconds(app, sub, device="cuda"))
        times, t_sub = np.asarray(times), np.asarray(t_sub)
        # benchmarks/paper_figs.py:run_app_comparison, inline: affine
        # calibration on 3 blocks, paper planner, simulate against DVO
        calib = [0, ds.n_blocks // 2, ds.n_blocks - 1]
        x = np.stack([np.ones(len(calib)), t_sub[calib]], axis=1)
        coef, *_ = np.linalg.lstsq(x, times[calib], rcond=None)
        est = np.maximum(coef[0] + coef[1] * t_sub, 1e-9)
        true_blocks = [BlockInfo(i, float(t)) for i, t in enumerate(times)]
        est_blocks = [BlockInfo(i, float(e)) for i, e in enumerate(est)]
        deadline = float(times.sum()) * SLACKS[-1]
        rep = simulate(plan_dvfs(est_blocks, deadline, planner="paper",
                                 power=POWER), true_blocks, power=POWER)
        dvo = simulate(plan_dvo(true_blocks, deadline, power=POWER),
                       true_blocks, power=POWER)
        row = {"ms_per_block": float(times.mean() * 1e3),
               "slice_ms": float(t_sub.mean() * 1e3),
               "cov": float(variety_stats(times).cov),
               "est_mape": float(np.mean(np.abs(est - times) / times)),
               "saving_vs_dvo": float(rep.improvement_vs(dvo)),
               "deadline_met": bool(rep.deadline_met),
               "generate_s": t_gen}
        check(bool(np.isfinite(times).all() and (times > 0).all()),
              f"{name}: block times are not finite and positive")
        rows[name] = row
        print(f"app {name}: {n} records a block, {row['ms_per_block']:.6f} ms "
              f"a block (5% slice {row['slice_ms']:.6f} ms), CoV "
              f"{row['cov']:.6f}, estimate MAPE {row['est_mape']:.6f}, "
              f"simulated saving vs DVO {100 * row['saving_vs_dvo']:+.4f}% "
              f"(paper power model), deadline_met={row['deadline_met']}, "
              f"host generation {t_gen:.3f} s")
    return rows


def event_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median ms of ``fn`` on the card, each run after evicting the L2 by
    reading a buffer five times its size (a read leaves no dirty lines for
    the timed run to write back)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()                                        # warm-up
    ts = []
    for _ in range(reps):
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def phase_times(main: dict, worst: dict) -> list:
    toks = main["first_chunk"]                  # (256, 2048, 256) int32
    k = main["k"]
    nb, rows, length = toks.shape
    sampled = toks[:, :k].contiguous()
    lens = torch.full((nb,), k, dtype=torch.int32, device=toks.device)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=toks.device)
    batched = (bs.block_stats_batched_cuda, ref.block_stats_batched_ref)
    single = (bs.block_stats_cuda, ref.block_stats_ref)
    pat_bytes = len(PATTERN) * 4
    shapes = {  # name -> (label, (kernel, plain), args, bytes read + written)
        "block_stats_batched": [
            ("sampled", batched, (sampled, lens, PATTERN),
             nb * k * length * 4 + nb * 4 + pat_bytes + nb * 12),
            ("full", batched, (toks, None, PATTERN),
             nb * rows * length * 4 + pat_bytes + nb * 12)],
        "block_stats": [
            ("one block", single, (toks[0], PATTERN),
             rows * length * 4 + pat_bytes + 12)],
    }
    entries = []
    for name, cases in shapes.items():
        per_shape = []
        for label, (kernel, plain), args, nbytes in cases:
            x = args[0]
            err = _max_err(kernel(*args), plain(*args))
            check(err == 0.0, f"{name} [{label}] differs from plain by {err}")
            worst[name] = max(worst[name], err)
            ms = event_ms(lambda: kernel(*args), flush)
            plain_ms = event_ms(lambda: plain(*args), flush)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            host = x.cpu().numpy()
            _, copy_s = sync_seconds(
                lambda: torch.from_numpy(host).to(toks.device))
            per_shape.append({"label": label, "shape": list(x.shape),
                              "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "share": bound / ms,
                              "h2d_copy_s": copy_s})
            print(f"  {name} [{label}] {tuple(x.shape)}: kernel {ms:.6f} ms, "
                  f"plain {plain_ms:.6f} ms, bound {bound:.6f} ms (bytes, "
                  f"{nbytes} at 3.35 TB/s) = {100 * bound / ms:.4f}% of the "
                  f"bound; host->device copy {copy_s:.6f} s; no single "
                  "PyTorch call computes these statistics (library_ms null)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + bs.SOURCE,
            "replaces": KERNELS[name],
            "launches": main["launches"][name],
            "max_abs_err": worst[name],
            "ms": sum(s["ms"] for s in per_shape),
            "plain_ms": sum(s["plain_ms"] for s in per_shape),
            "bound_ms": sum(s["bound_ms"] for s in per_shape),
            "bound_by": "bytes", "library_ms": None,
            "per_shape": per_shape})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    kind, smi = phase_card()
    phase_build()
    worst = phase_parity()
    main_path = phase_main_path()
    phase_small_path()
    phase_apps()
    print(f"times on {kind} ({smi}); ms and plain_ms are CUDA-event medians "
          "of 20 runs, each after evicting the L2:")
    kernels = phase_times(main_path, worst)
    print(f"total wall: {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
