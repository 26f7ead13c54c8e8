"""Batched serving engine with DV-DVFS slot scheduling.

The port of ``src/repro/serve/engine.py``.  Each decode window (a fixed
number of tokens for the whole batch) is a "block", the per-request SLO is
the deadline, and the planners of ``repro_torch.core`` pick each window's
clock.  ``generate`` keeps the reference's control flow step for step (an
untimed first step, a calibration window at f_max, the plan, then the
windows), so the two engines' ledgers have the same structure.  A window is
a Python loop of ``decode_step`` that updates the cache in place, and every
timed region ends in a device synchronise.  The frequencies are simulated
(``SimulatedActuator``) and the joules come from the ledger's power model;
nothing here sets or measures the card's clock or energy.

Not ported yet: ``replicas > 1`` (the cluster planner, ROADMAP Queue 1
item 1) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import BlockInfo, RooflineTimeModel, plan_dvfs, plan_dvo
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.dvfs_controller import EnergyLedger, SimulatedActuator

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass
class ServeConfig:
    batch: int = 4
    max_len: int = 512
    window: int = 16            # decode tokens per scheduling block
    slo_tokens_per_s: float = 0.0   # 0 = derive from measured f_max rate
    slack: float = 1.2          # deadline = slack * f_max time when no SLO given
    planner: str = "roofline"
    greedy: bool = True
    # multi-replica decode (the reference's cluster path, with its
    # replica_speeds / replica_nodes): only 1 is ported
    replicas: int = 1


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return torch.as_tensor(tree, device=device)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, sc: ServeConfig,
                 roofline: RooflineTimeModel | None = None, chips: int = 1,
                 device="cuda"):
        if sc.replicas > 1:
            raise NotImplementedError(
                "replicas > 1 needs the cluster planner, not ported yet "
                "(ROADMAP Queue 1 item 1)")
        self.cfg = cfg
        self.sc = sc
        self.device = resolve_device(device)
        self.params = _to(params, self.device)   # no copy when already there
        self.actuator = SimulatedActuator(roofline)
        self.ledger = EnergyLedger(chips=chips)
        self.dvo_ledger = EnergyLedger(chips=chips)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, prompts: dict):
        return T.prefill(self.params, self.cfg, prompts, self.sc.max_len)

    def _sample_token(self, logits):
        if self.cfg.n_codebooks:
            return logits.argmax(dim=-1).to(torch.int32)[:, None, :]
        return logits.argmax(dim=-1).to(torch.int32)[:, None]

    def _window(self, n_steps: int, tok, cache):
        """``n_steps`` greedy decode steps; returns (tokens (B, n[, K]), the
        last token, cache).  The cache is updated in place."""
        out = []
        for _ in range(n_steps):
            logits, cache = T.decode_step(self.params, self.cfg, tok, cache)
            tok = self._sample_token(logits)
            out.append(tok)
        return torch.cat(out, dim=1), tok, cache

    def generate(self, prompts: dict, n_tokens: int) -> dict:
        """Greedy-generate ``n_tokens`` for the batch with DV-DVFS windows."""
        sc = self.sc
        prompts = _to(prompts, self.device)
        logits, cache = self._prefill(prompts)
        tok = self._sample_token(logits)
        self._sync()
        toks = [tok]
        done = 0

        def run_window(n, cache):
            nonlocal tok, done
            win, tok, cache = self._window(n, tok, cache)
            toks.append(win)
            done += n
            return cache

        # the first decode step, untimed (the reference compiles here)
        cache = run_window(1, cache)
        self._sync()

        # measure one window at f_max to build the cost estimate
        n_cal = min(sc.window, max(n_tokens - 1, 0))
        if n_cal:
            t0 = time.perf_counter()
            cache = run_window(n_cal, cache)
            self._sync()
            window_fmax_s = time.perf_counter() - t0
        else:
            window_fmax_s = 0.0
        # the calibration window ran at f_max under both schemes
        self.ledger.record(window_fmax_s, 1.0)
        self.dvo_ledger.record(window_fmax_s, 1.0)

        remaining = max(n_tokens - done, 0)
        n_windows = int(np.ceil(remaining / sc.window))
        blocks = [BlockInfo(i, window_fmax_s, roofline=self.actuator.roofline)
                  for i in range(n_windows)]
        if sc.slo_tokens_per_s > 0:
            deadline = remaining * sc.batch / sc.slo_tokens_per_s
        else:
            deadline = window_fmax_s * n_windows * sc.slack
        plan = plan_dvfs(blocks, deadline, planner=sc.planner) \
            if n_windows else None
        self.plan = plan
        self.dvo_plan = plan_dvo(blocks, deadline) if n_windows else None

        for w in range(n_windows):
            n_w = min(sc.window, n_tokens - done)
            self.actuator.set(plan.blocks[w].rel_freq)
            t0 = time.perf_counter()
            cache = run_window(n_w, cache)
            self._sync()
            wall = time.perf_counter() - t0
            eff = self.actuator.effective_time(wall)
            self.ledger.record(eff, plan.blocks[w].rel_freq)
            self.dvo_ledger.record(wall, 1.0)

        return {"tokens": torch.cat(toks, dim=1),
                "energy": self.ledger.summary(),
                "energy_dvo": self.dvo_ledger.summary(),
                "n_generated": done + 1}
