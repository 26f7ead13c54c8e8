"""Time a model's prefill at full width on the card.

  PYTHONPATH=src python -m repro_torch.launch.prefill_timing [--arch ARCH]

Builds the architecture (default olmo-1b; e.g. ``--arch mamba2-1.3b``) at
its published width and depth (float32, random weights from seed 0;
attention through the flash kernel, Mamba layers through the ssd_scan
kernel), prefills 8 seeded prompts of 1024 tokens once to warm up and then
5 times, and prints each wall (host clock, up to a device synchronise),
their median, the card and the package it timed.  To compare two checkouts
on one card, run this file from either one with ``PYTHONPATH`` set to each
checkout's ``src`` in turns (A, B, B, A).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

ARCH, BATCH, PROMPT, REPS, SEED = "olmo-1b", 8, 1024, 5, 0


def prefill_walls(cfg, batch: int, prompt: int, reps: int,
                  device: torch.device) -> list:
    """Seconds of ``reps`` prefills of ``cfg`` after one warm-up."""
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(
        SEED), dtype=torch.float32, device=device)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (batch, prompt)).astype(np.int32), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    walls = []
    for _ in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        T.prefill(params, cfg, {"tokens": toks}, prompt)
        sync()
        walls.append(time.perf_counter() - t0)
    return walls[1:]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH,
                    help=f"architecture to prefill (default {ARCH})")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    arch = parse_args(argv).arch
    dev = torch.device("cuda")
    walls = prefill_walls(get_arch(arch, attn_impl_train="pallas"), BATCH,
                          PROMPT, REPS, dev)
    print(f"prefill {arch} {BATCH}x{PROMPT} on "
          f"{torch.cuda.get_device_name(dev)} ({repro_torch.__file__}): walls "
          f"{' '.join(f'{w:.6f}' for w in walls)} s, median "
          f"{float(np.median(walls)):.6f} s")


if __name__ == "__main__":
    main()
