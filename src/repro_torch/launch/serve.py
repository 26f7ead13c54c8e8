"""Serving CLI: --arch <id>, batched greedy generation with DV-DVFS window
scheduling on a smoke-sized config with random weights.

The port of ``src/repro/launch/serve.py``, with ``--device`` (default
``cuda``; pass ``cpu`` to run without a card):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core import RooflineTimeModel
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--planner", default="roofline",
                    choices=["paper", "global", "roofline"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rt = RooflineTimeModel.from_counts(
        flops=2 * cfg.param_count() * args.batch,
        hbm_bytes=2 * cfg.param_count(), coll_bytes=0)
    eng = ServingEngine(cfg, params,
                        ServeConfig(batch=args.batch, max_len=256, window=8,
                                    planner=args.planner), roofline=rt,
                        device=dev)
    shape = (args.batch, 16, cfg.n_codebooks) if cfg.n_codebooks \
        else (args.batch, 16)
    prompts = {"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab, shape).astype(np.int32)}
    if cfg.frontend == "patch":
        prompts["patch_embeds"] = np.zeros(
            (args.batch, cfg.n_patches, cfg.patch_dim), np.float32)
    out = eng.generate(prompts, n_tokens=args.tokens)
    sav = 1 - out["energy"]["busy_j"] / max(out["energy_dvo"]["busy_j"], 1e-9)
    print(f"[serve] arch={cfg.name} device={dev} "
          f"generated={out['n_generated']} energy=-{sav:.1%} vs DVO "
          f"(planner={args.planner}, simulated power model)")


if __name__ == "__main__":
    main()
