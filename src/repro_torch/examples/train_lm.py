"""End-to-end training example: train an LM on the block pipeline with the
DV-DVFS controller, checkpoints and restart.

Presets:
  tiny  (default) — the smoke config, about a minute on a CPU.
  100m            — the reference's "~110 M-param" olmo-family model (12 x
                    768, vocab 32768, batch 8 x 512): 163.6 M parameters,
                    113.2 M of them in the blocks and the rest in the
                    embedding and the untied head; a few hundred steps,
                    sized for one card; use --steps to trim.

The port of ``examples/train_lm.py``, with ``--device`` (default ``cuda``;
``cpu`` runs without a card).  Checkpoints go under the process's temp
directory unless ``--ckpt-dir`` says otherwise.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \\
          --steps 30 --device cpu
Resume after interruption (fault tolerance): run the same command again.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import BlockDataset
from repro_torch.device import resolve_device
from repro_torch.train import TrainConfig, Trainer


def make_cfg(preset: str):
    if preset == "tiny":
        return smoke_config("olmo-1b"), dict(batch=2, seq_len=64)
    if preset == "100m":
        cfg = get_arch("olmo-1b").replace(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
            d_ff=3072, vocab=32768, loss_chunk=512, attn_chunk_q=256,
            attn_chunk_k=256)
        return cfg, dict(batch=8, seq_len=512)
    raise SystemExit(f"unknown preset {preset}")


def main(argv=None, *, trainer_cls=Trainer) -> dict:
    """Train as the arguments say; returns ``Trainer.run``'s result.
    ``trainer_cls`` may be a subclass of ``Trainer`` that times or records
    the steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--no-dvfs", action="store_true")
    ap.add_argument("--planner", default="paper",
                    choices=["paper", "global", "roofline"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, sizes = make_cfg(args.preset)
    n_params = cfg.param_count() / 1e6
    print(f"arch={cfg.name} preset={args.preset} ~{n_params:.0f}M params "
          f"device={dev}")

    tc = TrainConfig(total_steps=args.steps, warmup=max(2, args.steps // 10),
                     ckpt_every=max(5, args.steps // 5),
                     ckpt_dir=args.ckpt_dir,
                     dvfs_enabled=not args.no_dvfs, planner=args.planner,
                     deadline_slack=1.2, **sizes)
    ds = BlockDataset(n_blocks=max(4, args.steps // tc.steps_per_block),
                      records_per_block=256, max_len=96, vocab=cfg.vocab)
    res = trainer_cls(cfg, tc, dataset=ds, device=dev).run(resume=True)

    sav = 1 - res["energy"]["busy_j"] / max(res["energy_dvo"]["busy_j"], 1e-9)
    print(f"loss {res['first_loss']:.3f} -> {res['final_loss']:.3f}")
    print(f"energy: {res['energy']['busy_j']:.1f} J "
          f"(-{sav:.1%} vs DVO), avg power {res['energy']['avg_w']:.0f} W/chip")
    print(f"stragglers: {len(res['straggler_events'])}; "
          f"checkpoints in {args.ckpt_dir}")
    return res


if __name__ == "__main__":
    main()
