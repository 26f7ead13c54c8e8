"""Production training entry point: --arch <id> over the block data pipeline
with DV-DVFS, checkpoints, restart and straggler detection.

The port of ``src/repro/launch/train.py``, with ``--device`` (default
``cuda``; pass ``cpu`` to run without a card).  ``--preset full`` trains the
full config; ``--preset smoke`` a reduced same-family config:

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --preset smoke --device cpu --steps 30 --ckpt-dir ck
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_arch, smoke_config
from repro_torch.data import BlockDataset
from repro_torch.device import resolve_device
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_launch_train"))
    ap.add_argument("--planner", default="paper",
                    choices=["paper", "global", "roofline"])
    ap.add_argument("--no-dvfs", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.preset == "smoke" \
        else get_arch(args.arch)
    print(f"[train] arch={cfg.name} preset={args.preset} device={dev} "
          f"~{cfg.param_count() / 1e6:.0f}M params")

    tc = TrainConfig(batch=args.batch, seq_len=args.seq_len, lr=args.lr,
                     total_steps=args.steps,
                     warmup=max(2, args.steps // 10),
                     ckpt_every=max(5, args.steps // 5),
                     ckpt_dir=args.ckpt_dir,
                     dvfs_enabled=not args.no_dvfs,
                     planner=args.planner, seed=args.seed)
    ds = BlockDataset(n_blocks=max(4, args.steps), records_per_block=128,
                      max_len=64, vocab=cfg.vocab, seed=args.seed)
    res = Trainer(cfg, tc, dataset=ds, device=dev).run(resume=True)
    sav = 1 - res["energy"]["busy_j"] / max(res["energy_dvo"]["busy_j"], 1e-9)
    print(f"[train] loss {res['first_loss']:.3f} -> {res['final_loss']:.3f} | "
          f"energy -{sav:.1%} vs DVO | "
          f"stragglers={len(res['straggler_events'])}")


if __name__ == "__main__":
    main()
