"""Fault-tolerant training runtime with first-class DV-DVFS integration.

The port of ``src/repro/train/loop.py``.  The loop is the paper's pipeline
at training granularity:
  data blocks -> (sample, estimate) -> frequency plan under an epoch deadline
  -> per-block actuation -> energy ledger,
wrapped with production concerns: gradient-accumulation microbatches,
global-norm clipping, LR schedule, atomic/async checkpoints with
auto-restore, straggler detection, and a failure-injection hook for the
restart tests.

The step is functional, as the reference's jitted step is pure: it returns
new parameter and optimizer trees and writes into none it is given, so the
calibration steps leave the initial weights as they were.  Gradients come
from autograd (``torch.autograd.grad``) in place of ``jax.value_and_grad``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import CostModel, RooflineTimeModel
from repro_torch.data import BlockDataset, pack_tokens
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, linear_warmup_cosine)
from repro_torch.parallel.shards import (gather_dim, is_dtensor, match,
                                         relayout, replicate_like)
from repro_torch.train.dvfs_controller import (DVFSController, EnergyLedger,
                                               SimulatedActuator)
from repro_torch.train.straggler import StragglerDetector
from repro_torch.tree import flatten, tree_leaves, tree_map, \
    tree_map_with_path

__all__ = ["TrainConfig", "make_train_step", "Trainer", "NodeFailure"]


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    seq_len: int = 256
    steps_per_block: int = 1
    num_microbatches: int = 1
    clip_norm: float = 1.0
    lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 200
    ckpt_every: int = 20
    ckpt_keep: int = 3
    # the reference's /tmp/repro_ckpt, under the process's temp directory
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    # DV-DVFS
    dvfs_enabled: bool = True
    planner: str = "paper"
    deadline_slack: float = 1.15     # epoch deadline = slack * est time at f_max
    error_margin: float = 0.05
    seed: int = 0


class NodeFailure(RuntimeError):
    """A step lost to a failed node: the trainer restores the newest valid
    checkpoint and goes on.  Other errors propagate (torch raises
    RuntimeError for shape errors and out-of-memory too, which a restore
    cannot cure)."""


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    num_microbatches: int = 1, clip_norm: float = 1.0,
                    lr_fn: Callable | None = None):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradients (microbatches summed in a float32
    accumulator and divided by their count), global-norm clipping,
    ``lr_fn(opt_state["step"])`` and AdamW.  Returns new trees.

    The trees may be DTensors (``parallel.distribute_tree``); then
    ``cfg.grad_shard`` shards the gradients as the reference pins them."""

    def pin_grads(grads):
        """Shard the grad accumulator (ZeRO-style): each DTensor gradient's
        first dim that divides by ``size`` (and is at least ``size``) over
        the ``grad_shard`` axis, so a gradient still summed across ranks
        (``Partial``) is reduce-scattered, not all-reduced.  Its other
        shardings stay; a plain tensor lies on no mesh and stays as it
        is."""
        if not cfg.grad_shard:
            return grads
        axis, size = cfg.grad_shard

        def pin(g):
            if not is_dtensor(g):
                return g
            names = g.device_mesh.mesh_dim_names
            if axis not in names:
                raise ValueError(f"grad_shard axis {axis!r} is not a dim of "
                                 f"the mesh {names}")
            for i, dim in enumerate(g.shape):
                if dim % size == 0 and dim >= size:
                    pl = [Replicate() if p.is_partial() else p
                          for p in g.placements]
                    pl[names.index(axis)] = Shard(i)
                    return g.redistribute(g.device_mesh, pl)
            return g

        return tree_map(pin, grads)

    def value_and_grad(params, mb):
        """(loss, gradient tree of params' structure and dtypes)."""
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = T.loss_fn(leaves, cfg, mb)
            grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                        allow_unused=True,
                                        materialize_grads=True)
        by_path = dict(zip(flatten(leaves), grads))
        return loss.detach(), tree_map_with_path(lambda k, _: by_path[k],
                                                 params)

    def step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, grads = value_and_grad(params, batch)
            grads = pin_grads(grads)
        else:
            m = num_microbatches
            for k, v in batch.items():
                if v.shape[0] % m:
                    # the reference's reshape to (m, B // m, ...) refuses it
                    raise ValueError(
                        f"batch leaf {k!r} has {v.shape[0]} rows, not "
                        f"divisible into {m} microbatches")
            gsum = None
            lsum = replicate_like(torch.zeros(
                (), dtype=torch.float32, device=tree_leaves(params)[0].device),
                tree_leaves(params)[0])
            # microbatch i is the reference's rows [i B/m, (i+1) B/m),
            # sliced from each leaf gathered along its rows (one all-gather
            # a leaf a step) and laid out as the leaf was; a rank's own rows
            # split m ways would be other rows, and another loss, once the
            # batch is sharded over more ranks than m
            whole = {k: gather_dim(v, 0) for k, v in batch.items()}
            for i in range(m):
                mb = {k: match(whole[k][i * (v.shape[0] // m):
                                        (i + 1) * (v.shape[0] // m)], v)
                      for k, v in batch.items()}
                l, g = value_and_grad(params, mb)
                g = tree_map(lambda b: b.float(), g)
                # the sum starts from the first microbatch's gradient (equal
                # to the reference's float32 zeros plus it): a zero
                # accumulator would lie replicated, and adding partial sums
                # to it makes some torch versions (2.11) all-reduce each
                # microbatch's gradient
                gsum = pin_grads(g if gsum is None else tree_map(
                    lambda a, b: a + b, gsum, g))
                lsum = lsum + l
            grads = tree_map(lambda g: g / m, gsum)
            loss = lsum / m
        with torch.no_grad():
            # each gradient still summed across ranks is reduced once, into
            # its moments' layout (ZeRO-1's shard), before the norm reads it
            # and the update uses it: the norm is then a sum over shards
            # and one scalar all-reduce
            grads = tree_map(relayout, grads, opt_state["m"])
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = lr_fn(opt_state["step"]) if lr_fn is not None else None
            params, opt_state = adamw_update(params, grads, opt_state,
                                             opt_cfg, lr)
        out = {"loss": loss, "grad_norm": gnorm}
        if lr is not None:
            out["lr"] = lr
        return params, opt_state, out

    return step


class Trainer:
    """End-to-end: block dataset -> packed batches -> DV-DVFS-planned steps,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ArchConfig, tc: TrainConfig,
                 dataset: BlockDataset | None = None,
                 roofline: RooflineTimeModel | None = None, chips: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tc = tc
        self.dataset = dataset or BlockDataset(
            n_blocks=max(4, tc.total_steps // tc.steps_per_block),
            records_per_block=512, max_len=128, vocab=cfg.vocab,
            seed=tc.seed)
        self.opt_cfg = AdamWConfig(lr=tc.lr, moment_dtype=cfg.opt_dtype)
        lr_fn = linear_warmup_cosine(tc.lr, tc.warmup, tc.total_steps)
        self._step_fn = make_train_step(
            cfg, self.opt_cfg, num_microbatches=tc.num_microbatches,
            clip_norm=tc.clip_norm, lr_fn=lr_fn)
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep)
        self.actuator = SimulatedActuator(roofline)
        self.ledger = EnergyLedger(chips=chips)
        self.dvo_ledger = EnergyLedger(chips=chips)  # counterfactual baseline
        self.straggler = StragglerDetector()
        self.controller: DVFSController | None = None
        self.history: list = []

    def _sync(self):
        """Wait for the device (``block_until_ready`` in the reference)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = T.init_params(self.cfg, gen, device=self.device)
        return params, adamw_init(params, self.opt_cfg)

    # ------------------------------------------------------------- data ----
    def _block_batch(self, block_idx: int):
        b = self.dataset.block(block_idx % self.dataset.n_blocks)
        packed = pack_tokens(b["tokens"], self.tc.batch, self.tc.seq_len)
        return ({"tokens": torch.from_numpy(packed.tokens).to(self.device),
                 "labels": torch.from_numpy(packed.labels).to(self.device)},
                packed.nonpad_tokens)

    # ------------------------------------------------------------ dv-dvfs --
    def _calibrate_and_plan(self, params, opt_state):
        """Sample blocks, calibrate the cost model on a few measured steps,
        plan frequencies for the epoch (paper Fig. 3 pre-processing box).
        The steps' results are thrown away: ``params`` is left as it is."""
        n_blocks = self.dataset.n_blocks
        feats, meas = [], []
        # measure 3 calibration blocks at f_max
        for i in range(min(3, n_blocks)):
            batch, nonpad = self._block_batch(i)
            t0 = time.perf_counter()
            self._step_fn(params, opt_state, batch)
            self._sync()
            meas.append(time.perf_counter() - t0)
            feats.append({"tokens": float(nonpad), "const": 1.0})
        cm = CostModel(("tokens", "const")).fit(feats, meas)

        block_feats = []
        for i in range(n_blocks):
            st = self.dataset.stats(i)
            # sampling sees record-level stats only (paper's <1% overhead)
            block_feats.append({"tokens": float(st.tokens) * self.tc.batch
                                * self.tc.seq_len / max(st.tokens_padded, 1),
                                "const": 1.0})
        self.controller = DVFSController(
            cost_model=cm, planner=self.tc.planner,
            error_margin=self.tc.error_margin,
            roofline=self.actuator.roofline, seed=self.tc.seed)
        blocks = self.controller.estimate_blocks(block_feats)
        est_total = sum(b.est_time_fmax for b in blocks)
        deadline = est_total * self.tc.deadline_slack
        self.controller.make_plan(blocks, deadline)
        return blocks

    # ------------------------------------------------------------- run -----
    def run(self, *, resume: bool = True,
            inject_failure_at: int | None = None) -> dict:
        params, opt_state = self._init_state()
        start_step = 0
        if resume:
            restored = self.ckpt.restore_latest(
                {"params": params, "opt": opt_state}, device=self.device)
            if restored is not None:
                tree, start_step = restored
                params, opt_state = tree["params"], tree["opt"]
                del tree
            del restored   # would hold these trees past the next step

        if self.tc.dvfs_enabled and self.controller is None:
            self._calibrate_and_plan(params, opt_state)

        step = start_step
        failed = False
        while step < self.tc.total_steps:
            block_idx = step // self.tc.steps_per_block
            batch, nonpad = self._block_batch(block_idx)
            rel_freq = (self.controller.freq_for_block(
                block_idx % self.dataset.n_blocks)
                if (self.tc.dvfs_enabled and self.controller) else 1.0)
            self.actuator.set(rel_freq)

            t0 = time.perf_counter()
            try:
                if inject_failure_at is not None and step == inject_failure_at \
                        and not failed:
                    failed = True
                    raise NodeFailure("injected node failure")
                params, opt_state, metrics = self._step_fn(
                    params, opt_state, batch)
                self._sync()
            except NodeFailure:
                # fault tolerance: restore newest valid checkpoint and continue
                restored = self.ckpt.restore_latest(
                    {"params": params, "opt": opt_state}, device=self.device)
                if restored is None:
                    params, opt_state = self._init_state()
                    step = 0
                else:
                    tree, step = restored
                    params, opt_state = tree["params"], tree["opt"]
                    del tree
                del restored   # would hold these trees past the next step
                continue
            wall = time.perf_counter() - t0

            eff = self.actuator.effective_time(wall)
            self.ledger.record(eff, rel_freq)
            self.dvo_ledger.record(wall, 1.0)
            slot = (self.controller.plan.blocks[0].slot_s
                    if (self.controller and self.controller.plan
                        and self.controller.plan.blocks) else None)
            self.straggler.observe(step, wall, planned_slot_s=slot)

            self.history.append({"step": step, "loss": float(metrics["loss"]),
                                 "rel_freq": rel_freq, "wall_s": wall,
                                 "effective_s": eff})
            step += 1
            if step % self.tc.ckpt_every == 0 or step == self.tc.total_steps:
                self.ckpt.save({"params": params, "opt": opt_state}, step)
        self.ckpt.wait()
        losses = [h["loss"] for h in self.history]
        return {
            "params": params,
            "final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "energy": self.ledger.summary(),
            "energy_dvo": self.dvo_ledger.summary(),
            "straggler_events": list(self.straggler.events),
            "history": self.history,
        }
