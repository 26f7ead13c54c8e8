"""Quickstart — the paper's pipeline end to end in about a minute.

1. build a multi-source block dataset with Zipfian variety,
2. sample + estimate per-block cost, plan frequencies under a deadline
   (Algorithm 1), compare against the Data-Variety-Oblivious baseline,
3. train a tiny LM with the DV-DVFS controller doing the same thing per
   training block, and report the energy ledger.

The port of ``examples/quickstart.py``: part 1 is NumPy and prints the
reference's text; part 2 trains the smoke olmo through the port's
``Trainer`` on ``--device`` (default ``cuda``; ``cpu`` runs without a card).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import smoke_config
from repro_torch.core import (CPU_PAPER_POWER, BlockInfo, plan_dvfs, plan_dvo,
                              simulate, zipf_block_sizes)
from repro_torch.data import BlockDataset
from repro_torch.device import resolve_device
from repro_torch.train import TrainConfig, Trainer


def scheduler_demo() -> dict:
    print("=== 1) DV-DVFS scheduling (paper Algorithm 1) ===")
    sizes = zipf_block_sizes(16, 100_000, z=1.0, seed=0)
    costs = sizes / sizes.mean() * 10.0          # seconds at f_max
    blocks = [BlockInfo(i, float(c)) for i, c in enumerate(costs)]
    deadline = float(costs.sum()) * 1.20         # firm deadline

    dvo = simulate(plan_dvo(blocks, deadline, power=CPU_PAPER_POWER), blocks,
                   power=CPU_PAPER_POWER)
    reports = {"dvo": dvo}
    for planner in ("paper", "global"):
        plan = plan_dvfs(blocks, deadline, planner=planner,
                         power=CPU_PAPER_POWER)
        rep = simulate(plan, blocks, power=CPU_PAPER_POWER)
        reports[planner] = rep
        print(f"  {planner:8s}: energy -{rep.improvement_vs(dvo):5.1%} "
              f"time +{rep.total_time_s / dvo.total_time_s - 1:5.1%} "
              f"deadline_met={rep.deadline_met}")
    return reports


def training_demo(device="cuda") -> dict:
    print("=== 2) DV-DVFS-managed LM training (tiny olmo config) ===")
    cfg = smoke_config("olmo-1b")
    ds = BlockDataset(n_blocks=4, records_per_block=64, max_len=48,
                      vocab=cfg.vocab, seed=1)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(batch=2, seq_len=64, total_steps=16, warmup=2,
                         ckpt_every=8, ckpt_dir=d, dvfs_enabled=True,
                         deadline_slack=1.25)
        res = Trainer(cfg, tc, dataset=ds, device=device).run(resume=False)
    sav = 1 - res["energy"]["busy_j"] / max(res["energy_dvo"]["busy_j"], 1e-9)
    print(f"  loss {res['first_loss']:.2f} -> {res['final_loss']:.2f}, "
          f"energy -{sav:.1%} vs DVO (simulated actuator), "
          f"{len(res['straggler_events'])} straggler events")
    return res


def main(argv=None) -> dict:
    """Both parts; their reports (part 1) and the trainer's result (part 2).
    The device is resolved first, so a missing card stops the run before
    any work."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return {"scheduler": scheduler_demo(), "training": training_demo(dev)}


if __name__ == "__main__":
    main()
