"""Time the SSD backward kernels at mamba2-1.3b's heads.

  PYTHONPATH=src python src/repro_torch/launch/ssd_bwd_timing.py

For (B, S) = (8, 256) (a training step of 8 x 256 tokens) and (8, 1024),
with mamba2-1.3b's 64 heads of 64 columns, one B/C group and d_state 128,
makes seeded float32 inputs as ``chip_smoke.py`` does (x a reshape, B and C
strided slices of one tensor) and a cotangent of y, and prints what
``time_shape`` gives for them on the card: ``ssd_scan_bwd_cuda``'s time
(``ms``: the median of 20 CUDA-event timings, each after evicting the L2 by
reading 256 MiB), each of its three device kernels' (``kernels_us``: the
profiler's mean device time of each over 5 calls) and the bound
(``bound``), beside the card and the package it timed.  ``chip_smoke.py``
times the backward through ``time_shape`` too.  To compare two checkouts on
one card, run this file with ``PYTHONPATH`` set to each checkout's ``src``
in turns (A, B, B, A).
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

import repro_torch
from repro_torch.device import F32_FLOPS, HBM_BYTES_PER_S
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch.block_stats_timing import event_ms, traced

HEADS = dict(h=64, g=1, p=64, n=128)     # mamba2-1.3b
SHAPES = ((8, 256), (8, 1024))
KERNELS = ("ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel",
           "ssd_bwd_reduce_kernel")


def inputs(rng, b: int, s: int, dev) -> tuple:
    """x, dt, a_log, B, C and dy (float32) as the model hands them in."""
    h, g, p, n = HEADS["h"], HEADS["g"], HEADS["p"], HEADS["n"]

    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dev)

    bc = normal(b, s, 2 * g * n)
    return (normal(b, s, h * p).reshape(b, s, h, p),
            torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h)).astype(
                np.float32)).to(dev),
            torch.from_numpy(rng.uniform(-1, 1, h).astype(np.float32)).to(
                dev),
            bc[..., :g * n].reshape(b, s, g, n),
            bc[..., g * n:].reshape(b, s, g, n),
            normal(b, s, h, p))


def bound(b: int, s: int, h: int, g: int, p: int, n: int) -> dict:
    """The least time (ms) an H100 could take for the SSD backward at this
    shape in float32, the larger of its operations
    (``ss.flops_per_token_head`` for each of B S H (token, head)s) at the
    float32 rate and its bytes
    (x, dy, dt, B, C and a_log read once; dx, ddt, dB, dC and da_log
    written once) at the memory rate."""
    per, chunk = ss.flops_per_token_head(s, p, n)
    flops = int(round(per * b * s * h))
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * g * n
                  + 2 * h)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "bound_chunk": chunk}


def kernels_us(call, reps: int = 5) -> dict:
    """Mean device time (us) of each of ``KERNELS`` over ``reps`` calls, as
    torch.profiler records it (``traced``, a spin kernel first in each
    step).  A session that recorded no event of one of the kernels is run
    again, up to six sessions in all."""
    call()

    def run():
        torch.cuda._sleep(2_000_000)
        for _ in range(reps):
            call()
    for _ in range(6):
        prof = traced(run)
        out = {}
        for e in prof.key_averages():
            name = re.search(r"ssd_bwd_[a-z]+_kernel", e.key)
            if name and e.self_device_time_total > 0:
                out[name.group(0)] = e.self_device_time_total / e.count
        if set(out) == set(KERNELS):
            return out
    raise RuntimeError("six profiler sessions, none recorded every SSD "
                       f"backward kernel ({', '.join(KERNELS)})")


def time_shape(args: tuple, dy: torch.Tensor, flush: torch.Tensor) -> dict:
    """``ssd_scan_bwd_cuda`` on x, dt, a_log, B, C (``args``) and a
    cotangent ``dy`` of y timed on the card (``ms``, ``kernels_us``) beside
    its ``bound``."""
    x, bm = args[0], args[3]
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]

    def call():
        return ss.ssd_scan_bwd_cuda(*args, dy, None)
    return {"ms": event_ms(call, flush), "kernels_us": kernels_us(call),
            **bound(b, s, h, g, p, n)}


def main() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for b, s in SHAPES:
        *args, dy = inputs(rng, b, s, dev)
        out[f"{b}x{s}"] = time_shape(tuple(args), dy, flush)
    print(f"ssd_scan_bwd on {torch.cuda.get_device_name(dev)} "
          f"({repro_torch.__file__}): {json.dumps(out)}")


if __name__ == "__main__":
    main()
