"""Batched serving with DV-DVFS slot scheduling.

Decode at this batch is memory-bandwidth-bound — exactly the regime where
the roofline planner harvests free energy savings: the clock drops to the
zero-cost point without hurting the token SLO.

The port of ``examples/serve_batch.py``: random weights from
``torch.Generator`` seed 0 on ``--device`` (default ``cuda``; ``cpu`` runs
without a card), and the decode roofline of the H100
(``repro_torch.device.H100``) unless ``serve`` is given another ``spec``;
the reference plans on the TPU v5e's.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batch --tokens 64 \\
          --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import ChipSpec, RooflineTimeModel
from repro_torch.device import H100, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import ServeConfig, ServingEngine


def serve(arch: str = "olmo-1b", *, batch: int = 4, tokens: int = 64,
          planner: str = "roofline", device="cuda",
          spec: ChipSpec = H100) -> tuple:
    """Serve ``batch`` seeded prompts of 32 tokens for ``tokens`` new ones;
    returns ``(out, engine)``."""
    dev = resolve_device(device)
    cfg = smoke_config(arch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)

    # analytic decode roofline for the TARGET chip (weights+cache streaming)
    rt = RooflineTimeModel.from_counts(
        flops=2 * cfg.param_count() * batch,
        hbm_bytes=2 * cfg.param_count(),  # bf16 weight stream per step
        coll_bytes=0, spec=spec)
    print(f"decode zero-cost clock: {rt.zero_cost_freq():.2f} × f_max")

    eng = ServingEngine(cfg, params,
                        ServeConfig(batch=batch, max_len=512, window=8,
                                    planner=planner, slack=1.15),
                        roofline=rt, device=dev)
    prompts = {"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab, (batch, 32)).astype(np.int32)}
    out = eng.generate(prompts, n_tokens=tokens)
    sav = 1 - out["energy"]["busy_j"] / max(out["energy_dvo"]["busy_j"], 1e-9)
    print(f"generated {out['n_generated']} tokens/seq × {batch} seqs")
    print(f"energy -{sav:.1%} vs DVO at f_max "
          f"(planner={planner}, simulated actuator)")
    return out, eng


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--planner", default="roofline",
                    choices=["paper", "global", "roofline"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return serve(args.arch, batch=args.batch, tokens=args.tokens,
                 planner=args.planner, device=args.device)


if __name__ == "__main__":
    main()
