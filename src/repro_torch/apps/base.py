"""App protocol + wall-time measurement used by the sampling estimator.

Port of ``src/repro/apps/base.py``.  On the card a run is timed with CUDA
events after a synchronise; on the CPU with ``perf_counter``.  The warm-up
run is left out of the timing, as in the reference.
"""
from __future__ import annotations

import time
from typing import Protocol

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device

__all__ = ["App", "measure_block_seconds"]


class App(Protocol):
    name: str

    def run(self, block, *, device="cuda"): ...   # block: dict of arrays
    def flops(self, stats: dict) -> float: ...
    def cost_features(self, stats: dict) -> dict: ...


def measure_block_seconds(app: App, block, *, repeats: int = 3,
                          device="cuda") -> float:
    """Median seconds of one ``app.run`` over ``block`` on ``device``
    (the block is moved there first; warm-up excluded)."""
    dev = resolve_device(device)
    blk = {k: to_device(v, dev) for k, v in block.items()}
    app.run(blk, device=dev)                  # warm-up
    ts = []
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev):
            for _ in range(repeats):
                torch.cuda.synchronize()
                start.record()
                app.run(blk, device=dev)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            app.run(blk, device=dev)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
