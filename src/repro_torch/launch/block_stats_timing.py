"""Time the block-statistics kernel at the DV-DVFS main path's shapes.

  PYTHONPATH=src python src/repro_torch/launch/block_stats_timing.py

Makes the main path's first chunk (256 blocks of 2048 records x 256 tokens,
``BlockDataset`` seed 0, as ``chip_smoke.py`` does) and times four calls on
the card: ``block_stats_batched_cuda`` on the full chunk and on its first
103 rows a block (the 5% sample, int32 lengths on the card),
``block_stats_cuda`` on one block, and ``block_stats_cuda`` on four tokens
(the cost of a call with next to no work).  ``ms`` is the median of 20
CUDA-event timings, each after evicting the L2 by reading 256 MiB, as in
``chip_smoke.py``; ``kernel_ms`` the median time the profiler records for
the kernel itself.  It prints both beside the byte bound (tokens, lengths,
pattern and output over 3.35 TB/s), the card and the package it timed.  To
compare two checkouts on one card, run this file with ``PYTHONPATH`` set to
each checkout's ``src`` in turns (A, B, B, A).
"""
from __future__ import annotations

import json

import numpy as np
import torch

import repro_torch
from repro_torch.data import BlockDataset
from repro_torch.device import HBM_BYTES_PER_S
from repro_torch.kernels import block_stats as bs

MAIN = dict(n_blocks=256, records_per_block=2048, max_len=256, vocab=32768,
            variety_z=1.0, seed=0)
SAMPLED_ROWS = 103          # 5% of 2048, the main path's k
PATTERN = (17, 23, 5)


def event_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median ms of ``fn`` on the card, each run after evicting the L2 by
    reading ``flush``, a buffer several times its size (a read leaves no
    dirty lines for the timed run to write back)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    ts = []
    for _ in range(reps):
        flush.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def kernel_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
    """Median ms that torch.profiler records on the card for the kernel
    named ``block_stats_kernel`` in calls of ``fn``, each after evicting the
    L2 as ``event_ms`` does: the kernel alone, without the launch and the
    events around it."""
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "block_stats_kernel" in e.name]
    return float(np.median(times)) / 1e3


def cases(toks: torch.Tensor, k: int) -> dict:
    """label -> (call, bytes the call must read and write) at the main
    path's shapes: the full chunk, its first k rows, one block."""
    nb, rows, length = toks.shape
    sampled = toks[:, :k].contiguous()
    lens = torch.full((nb,), k, dtype=torch.int32, device=toks.device)
    pat = len(PATTERN) * 4
    return {
        "full": (lambda: bs.block_stats_batched_cuda(toks, None, PATTERN),
                 nb * rows * length * 4 + pat + nb * 12),
        "sampled": (lambda: bs.block_stats_batched_cuda(sampled, lens,
                                                        PATTERN),
                    nb * k * length * 4 + nb * 4 + pat + nb * 12),
        "one block": (lambda: bs.block_stats_cuda(toks[0], PATTERN),
                      rows * length * 4 + pat + 12),
        # four tokens: what a call costs when there is next to no work
        "floor": (lambda: bs.block_stats_cuda(toks[0, :1, :4], PATTERN),
                  16 + pat + 12),
    }


def main() -> None:
    dev = torch.device("cuda")
    _, toks = next(BlockDataset(**MAIN).iter_token_chunks(MAIN["n_blocks"],
                                                          device=dev))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for label, (call, nbytes) in cases(toks, SAMPLED_ROWS).items():
        out[label] = {"ms": event_ms(call, flush),
                      "kernel_ms": kernel_ms(call, flush),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    print(f"block_stats on {torch.cuda.get_device_name(dev)} "
          f"({repro_torch.__file__}): {json.dumps(out)}")


if __name__ == "__main__":
    main()
