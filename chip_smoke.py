#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. card: name, compute capability, torch/CUDA versions, power limit, and
     float32 matrix products in full float32 (no TF32);
  2. build: nvcc builds every CUDA source of the port (one nvcc each, all
     started together);
  3. every kernel against its plain PyTorch version on the card: block
     statistics on edge cases (ragged and poisoned rows, odd shapes, mass
     past 2**24, spans and views off 16-byte boundaries, a 100000-token row,
     5000 blocks, int64 lengths past int32, a block of 0 rows on reused
     output memory, one block over a cluster of 16, ...), exactly; flash
     attention in float32 and bfloat16 on MHA, GQA, SWA, non-causal and odd
     shapes, within 2e-5 and 2e-2; the
     SSD scan against the naive recurrence and the plain chunked version
     (y, and the final state) on the reference's sweep, mamba2-1.3b's and
     jamba's head shapes, grouped B/C, a partial last chunk, P = 8 and a
     sequence under one chunk, within 5e-4 and 5e-2; then each wrapper on
     a batch of no rows (empty outputs and gradients, no launch);
  4. the DV-DVFS main path at full size: token blocks -> sampled estimates
     (one block_stats_batched launch a chunk) -> DV-DVFS plans -> simulated
     run against the full-block truth, then the same estimates planned over
     the four nodes of examples/cluster_sim.py, uncapped and under a power
     cap, with its kernels' launch counts read after it;
  5. the runtime on those estimates, all host work: the four-node plan
     executed by ``stream_run`` with zero actuation and no cap (bit for bit
     the block-boundary loop), then with online re-planning, migration,
     actuation, a cap, a slowdown and a transient crash (the vector engine
     against the scalar oracle, report and event log, and the ledger
     audit), read by the fleet observatory: each node's wall split into
     its causes (explain_miss), the energy channels, one ablation per
     mechanism with its makespan and deadline (profile_mechanisms,
     ablate), the run again with the online re-planner's replan_threshold
     narrowed, the run diff against the ablation that moves the makespan
     most, the watchdog's alerts, and a Chrome trace and a Prometheus
     exposition held to their validators; the serving fabric on that plan
     under three tenants (both engines, its conservation audit, its tenant
     rows and its worst missed job explained), and the reference
     benchmark's fleet scenario at 10,000 x 16 (both engines) and
     1,000,000 x 100 (vector; then again with streamed metrics and a ring
     flight recorder, for their host cost), with host walls;
  6. the same path on a small dataset, card against CPU;
  7. the five apps on the card at the paper-figure block sizes, with the
     paper's estimate -> plan -> simulate comparison against DVO at the
     tight and firm slacks, through the port's
     examples.paper_figs.run_app_comparison;
  8. the serving path at full width: olmo-1b (16 layers, d_model 2048,
     float32, random weights from a seed) serves 8 prompts of 1024 tokens
     through ServingEngine.generate (prefill through the flash kernel, then
     DV-DVFS decode windows), with the flash launch count read after it and
     the prefill's logits held against the plain chunked attention; then
     the same weights and traffic with the int8 KV cache (kv_quant, the
     reference's opt decode config): 16 flash launches in the prefill and
     none in decode, the cache's bytes against float32's, decode time,
     peak, greedy tokens against the float32-cache run, each dequantized
     K/V element within half its row's step and the first decode step's
     logits within a bound argued from it;
  9. the serving path at smoke size, card against CPU;
 10. the Mamba serving path at full width: mamba2-1.3b (48 layers, d_model
     2048, float32, random weights from a seed) serves the same traffic
     through ServingEngine.generate (each layer's SSD through the ssd_scan
     kernel in the prefill, the plain recurrence in decode), with the launch
     counts read after the prefill and after the run, the kernel held
     against the plain chunked version on the first and last layers' real
     inputs, and the final state checked end to end (prefill S-1 tokens and
     decode the last against the S-token prefill's logits);
 11. the Mamba serving path at smoke size, card against CPU;
 12. the MoE serving path at full width: qwen2-moe-a2.7b (24 layers, d_model
     2048, 60 routed experts top-4 and 4 shared, float32, random weights
     from a seed) serves the same traffic (prefill through the flash kernel
     and the MoE FFN over all 8192 tokens at once, decode through the plain
     products), with the flash launch count read after it, the kernel held
     against its plain version on the first and last layers' real q/k/v, a
     second prefill bit-identical to the first, and the routes and logits
     of a plain chunked-attention prefill compared; then the same traffic
     over three replicas planned by the cluster planner;
 13. the MoE serving paths at smoke size, card against CPU: qwen2-moe-a2.7b,
     and jamba-1.5-large-398b (Mamba, attention and MoE layers in one
     model, through both the flash and the SSD kernels);
 14. kernel, plain and library times at the main paths' shapes, beside the
     least time the card could take; for flash attention and the SSD scan
     also registers, spills, occupancy, the SM clock and power under load,
     and (SSD) the device kernels one call launches and the FLOP the design
     does beside the bound's; for block statistics registers, spills,
     shared memory, CTAs an SM, the cluster size and grid, one device kernel
     a call (profiler), the SM clock and power under load and a read
     yardstick (torch.sum of the same tokens, not the same function);
 15. the examples of repro_torch.examples on the card, each through its
     entry point: cluster_sim, calibrate and quickstart at their defaults,
     serve_batch on the H100's roofline, bigdata_apps at its defaults,
     train_lm at its 100m preset's full
     width (163,577,856 parameters) for 30 steps, each one's printed
     numbers finite and its deadlines met where its text says so, with
     walls, and train_lm's steps timed by CUDA events;
 16. the sharded path (DTensors on a DeviceMesh) at world size 1 under a
     one-rank NCCL process group (its store a file under TMPDIR):
     int8_all_reduce (1000 values within one quantization step; olmo-1b's
     embedding table, with walls) and hierarchical_grad_reduce; olmo-1b at
     full width with its weights laid out by param_specs (wrapped, not
     copied): the serving traffic's prefill (flash once a layer on the
     local heads, logits against plain within 1e-5) and 16 greedy decode
     steps on a cache laid out by cache_specs (tokens equal), then two
     train steps with ZeRO-1 moments and gradients over 'data' (losses and
     weights within 1e-5 relative), each beside the plain path's walls;
     qwen2-moe-a2.7b at full width with groups and experts over 'data'
     (flash 24 times, logits within 1e-6, routes identical, under 80 GB);
     mamba2-1.3b and jamba at smoke size (the SSD kernel on each rank's
     heads), and a smoke mamba2-1.3b train step (the SSD's backward on the
     rank's heads) against plain;
 17. the training path at full width: olmo-1b (1,279,787,008 float32
     parameters, random from a seed) trained through Trainer.run under
     deterministic algorithms: 3 calibration steps, the DV-DVFS plan, 8
     steps of 8 x 256 tokens (remat, chunked attention, so no kernel
     wrapper launches), checkpoints at steps 4 and 8 (keep 1) under TMPDIR,
     a node failure at step 6 restored from step 4, with the step walls,
     TFLOP/s and memory peaks, the save and restore walls, the repeated
     steps' losses bit-identical and the weights unchanged by calibration;
     then which gradient leaves differ between two identical backward
     passes without deterministic algorithms; then, at smoke size, a
     25-step run whose loss decreases, a failure-and-restore run equal bit
     for bit to a clean one, a backward through the flash kernel refused,
     and smoke mamba2-1.3b and jamba trained two steps on the card against
     the CPU (the SSD kernel and its backward kernels launched as
     counted);
 18. Mamba training at full width: mamba2-1.3b (1,445,363,712 float32
     parameters, random from a seed) trained through Trainer.run under
     deterministic algorithms (3 calibration steps, the DV-DVFS plan, 6
     steps of 8 x 256 tokens, remat, no checkpoint), each layer's SSD
     through the ssd_scan kernel (twice a step: the forward and remat's
     recomputation) and its backward kernels (once), with the step walls,
     tokens/s and memory peaks and the losses falling; then one more
     backward with the first and last layers' real SSD inputs and
     cotangents recorded, the backward kernels' five gradients held against
     autograd of the plain chunked version on the card; then the model in
     bfloat16, one loss_fn backward with its 48 bfloat16 backward launches,
     layers 0 and 47's gradients against the plain version's bfloat16 ones
     and its peak; then the backward kernels timed in float32 and bfloat16
     at (8, 256) and (8, 1024) tokens beside their bound, the plain
     version, and each kernel's registers, spills, shared memory and CTAs
     an SM;
 19. the reference's train_4k cell in bfloat16 (configs/shapes.py;
     launch/dryrun.py runs it on meta): olmo-1b and mamba2-1.3b at full
     width, bfloat16 weights from a seed and moments at the config's
     opt_dtype, at the rows of the cell's 256 one card holds
     (launch/cell_memory.py's TRAIN_ROWS, reckoned from shapes) of 4,096
     packed tokens, make_train_step with the arch's TRAIN_MICROBATCHES,
     four steps on one batch (mamba2-1.3b two): losses finite and
     falling, the leaves'
     dtypes kept, no kernel wrapper launched for olmo-1b (attention trains
     through chunked), 96 x m ssd_scan and 48 x m ssd_scan_bwd launches a
     step for mamba2-1.3b, every call on bfloat16 inputs, layers 0 and
     47's bfloat16 SSD backward on the step's real inputs and cotangents
     against the plain version's, the backward kernels timed at that shape
     beside their bound; step walls, tokens/s, model TFLOP/s, and each
     step's peak under 80 GB and beside cell_memory.reckon's (reckoned in
     processes of their own, started with phase 17);
 20. the reference's production cells in bfloat16 (configs/shapes.py;
     launch/dryrun.py runs them on meta): olmo-1b, mamba2-1.3b,
     qwen2-moe-a2.7b, musicgen-large, pixtral-12b, yi-6b and minitron-8b,
     each at full width with bfloat16 weights from a seed, at the rows of
     the cells' global
     batches one card holds (launch/cell_memory.py's ROWS, reckoned from
     shapes): prefill_32k, T.prefill of 32,768 positions (pixtral's
     first 1,024 of them patches) into a bfloat16 cache, with one
     bfloat16 kernel launch a layer, layers 0 and last's kernel outputs on
     the first and last rows against the plain version on their real
     inputs (also within 2 bfloat16 steps of their own largest value),
     and the last logits against a prefill through the plain path
     on one row (greedy flips counted), every layer's kernel call on that
     row against the plain version; decode_32k, a prefill of 32,752
     positions then 16 greedy decode steps up to position 32,767, no
     launch in decode, one step traced, the first step's logits against
     the plain path's; walls, peaks under 80 GB, and each kernel timed at
     its cell's shape beside its bound; then mamba2-1.3b's long_500k at
     its one row: a prefill of 524,272 positions with every layer's SSD
     call held against the plain chunked SSD as it goes, 16 greedy decode
     steps up to position 524,287 with no launch (one traced), the
     prefill's and first step's logits against the plain path's, the peak
     beside cell_memory.reckon's, and the SSD timed at 524,288 positions
     with the scan kernel's grid against the card's SMs;
 21. the dry run (launch/dryrun.py) of olmo-1b train_4k at its two
     microbatches, mamba2-1.3b train_4k, qwen2-moe-a2.7b train_4k on the
     512-rank mesh (one microbatch each), jamba long_500k, olmo-1b
     long_500k (the reference's skip), olmo-1b prefill_32k on the 512-rank
     mesh and olmo-1b train_4k there at 16 microbatches (16 rows over 32
     batch ranks, one on rank 0), and in the hillclimbed layouts (--opt)
     olmo-1b train_4k (dp: its all-reduces below 1% of the float32
     gradient) and decode_32k (an int8 KV cache); no cell launches a
     kernel; each cell a child process on the host
     (meta DTensors over a 256/512-rank fake process group, nothing on
     the card), four at a time, started with phase 17 (phases 17-19 are
     checkpoint I/O and steps that keep the card busy) and read before
     phase 20, with each record's trace
     wall, FLOPs, collective bytes by kind and memory a device.

Each phase's wall is printed before the total.

With ``--cards 4`` (``python3 chip_smoke.py --cards 4 [--log-dir DIR]
[--phases checks,nccl,parity,cells,train]`` on a machine with four cards)
it runs only the sharded path over the four cards under NCCL, one process
a card, each its card's current device: every check of
``launch/mesh_checks.py`` (the gloo tests' checks, on CUDA tensors, each
held to its test's tolerance), NCCL's walls for the collectives the
sharded path issues, the 2-layer sharded against unsharded parity of
qwen1.5-32b and mixtral-8x7b at full width (weights drawn shard by shard,
``models/shard_init.py``; card 0 draws the whole tree), their production
cells prefill_32k and decode_32k on (data 1, model 4) at full width and
depth (``launch/cell_memory.py``'s MESH4_ROWS), each rank's flash calls
and peaks held as in phase 20, and the train_4k cells of
``cell_memory.MESH4_TRAIN`` (yi-6b on (data 1, model 4), musicgen-large on
(data 2, model 2)) at full width and depth in bfloat16: the reference's
config (chunked attention with remat, its microbatches, ZeRO-1 moments at
opt_dtype on their shards, the packed batch over 'data'), three steps on
one batch with losses finite and equal on every rank, the first within
0.25 of the init's cross-entropy (``loss_at_init``), a step lowering
it, and a rise after AdamW's first update matched by card 0's unsharded
2-layer steps on the same batch, leaf
dtypes and placements kept, no kernel launched, each step's walls split
into microbatches and the update, tokens/s and model TFLOP/s of the mesh,
each peak under 80 GB and within 2 GB of ``cell_memory.reckon(mesh=)``'s,
step 0's collectives equal by kind and bytes to the dry run's count of the
same cell on a fake mesh of that shape, rank 0's NCCL share of one traced
step, and the arch cut to 2 layers trained two steps sharded against card
0 unsharded within ``mesh_checks.BF16_STEP_TOL``.  ``--phases`` runs a
subset, in that order.  It refuses to run unless it sees four cards; each
rank's log and numbers go to ``--log-dir`` (a temporary directory by
default).

It ends with one JSON line of per-kernel numbers, the nvidia-smi name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line.  The
joules and savings it prints come from power models in simulation (the
paper's for the DV-DVFS path, the copied TPU_V5E_POWER curve for serving);
nothing here measures the card's energy.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import datetime
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.apps import ALL_APPS  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.cluster import (ClusterReport, NodeReport,  # noqa: E402
                                 NodeSpec, assign_blocks, plan_cluster_arrays,
                                 simulate_cluster, simulate_cluster_reference)
from repro_torch.configs import (SHAPES, get_arch,  # noqa: E402
                                smoke_config)
from repro_torch.core import (CPU_PAPER_POWER, BlockArrays,  # noqa: E402
                              BlockInfo, EstimateArrays,
                              FrequencyLadder, PowerModel, RooflineTimeModel,
                              plan_dvo, plan_dvo_arrays, simulate,
                              variety_stats)
from repro_torch.data import BlockDataset, pack_tokens  # noqa: E402
from repro_torch.device import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                                H100, HBM_BYTES_PER_S)
from repro_torch.examples import calibrate as ex_calibrate  # noqa: E402
from repro_torch.examples import bigdata_apps as ex_bigdata_apps  # noqa: E402
from repro_torch.examples import cluster_sim as ex_cluster_sim  # noqa: E402
from repro_torch.examples import paper_figs  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import serve_batch as ex_serve_batch  # noqa: E402
from repro_torch.examples import train_lm as ex_train_lm  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import block_stats as bs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch import (cell_memory, dryrun,  # noqa: E402
                                mesh_checks, ssd_bwd_timing)
from repro_torch.launch.block_stats_timing import (  # noqa: E402
    event_ms, traced)
from repro_torch.launch.mesh import make_mesh, mesh_shape_dict  # noqa: E402
from repro_torch.launch.optconfig import (  # noqa: E402
    TRAIN_MICROBATCHES, build_cfg)
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import shard_init  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import LeafShape, init_scale  # noqa: E402
from repro_torch.models.convert import SEP, flatten  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel import (batch_specs,  # noqa: E402
                                  distribute_tree,
                                  hierarchical_grad_reduce,
                                  int8_all_reduce, param_specs,
                                  zero1_specs)
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.obs import (Scenario, StreamingMetrics,  # noqa: E402
                             Watchdog, ablate, build_spans, diff_runs,
                             explain_energy, explain_miss, format_table,
                             mechanism_columns, neutralize,
                             profile_mechanisms,
                             standard_rules, tenant_rows, to_prometheus,
                             validate_chrome_trace, validate_prometheus,
                             write_chrome_trace)
from repro_torch.pipeline import (ArrivalSpec,  # noqa: E402
                                  PipelineConfig, TenantSpec, plan_estimates,
                                  stream_estimates_tokens, stream_run,
                                  token_chunk_estimates, token_cost)
from repro_torch.runtime import (ActuationModel,  # noqa: E402
                                 CheckpointModel, FaultEvent, MigrationModel,
                                 NodeFailureEvent, RecoveryPolicy,
                                 RuntimeConfig, check_conservation,
                                 run_cluster)
from repro_torch.serve import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving import (check_serving_conservation,  # noqa: E402
                                 run_serving)
from repro_torch.train import TrainConfig, Trainer, make_train_step  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.tree import flatten as tree_flatten  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

PATTERN = (17, 23, 5)
POWER = CPU_PAPER_POWER       # the paper's power model (formula 7)
SLACKS = (1.08, 1.20)         # tight and firm deadlines, benchmarks/paper_figs.py

# the main path: 1024 blocks of 2048 records x 256 tokens (2 GiB of int32),
# streamed 256 blocks (512 MiB) at a time
MAIN = dict(n_blocks=1024, records_per_block=2048, max_len=256, vocab=32768,
            variety_z=1.0, seed=0)
CHUNK = 256
FRACTION = 0.05

KERNELS = {
    "block_stats_batched": "src/repro/kernels/block_stats.py:104",
    "block_stats": "src/repro/kernels/block_stats.py:62",
    "flash_attention": "src/repro/kernels/flash_attention.py:28",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:27",
    "ssd_scan_bwd": "no TPU kernel: the gradient of "
                    "src/repro/kernels/ssd_scan.py:27's function, which the "
                    "reference takes with jax.grad of "
                    "src/repro/models/mamba2.py:86",
}

# the serving path: olmo-1b at its published width and depth, float32 (the
# reference serves in float32), 8 prompts of 1024 tokens, 64 new tokens in
# DV-DVFS windows of 16
SERVE = dict(arch="olmo-1b", batch=8, prompt=1024, max_len=1152, window=16,
             n_tokens=64, slack=1.2, seed=0)
MAMBA_SERVE = dict(SERVE, arch="mamba2-1.3b")   # the same traffic
MOE_SERVE = dict(SERVE, arch="qwen2-moe-a2.7b")  # the same traffic
# the reference's multi-replica case (tests/test_serve.py:62-91)
REPLICAS = dict(replicas=3, replica_speeds=(1.0, 0.8, 1.25), slack=1.4)
# the main path's cluster: the four nodes of examples/cluster_sim.py:45-46,
# its deadline rule (1.2x the largest f_max time of a round-robin split,
# :47-49), and a power cap at this share of the uncapped plan's peak draw
NODE_SPEEDS = (1.0, 0.7, 1.3, 0.9)
NODE_SLACK = 1.2
CAP_SHARE = 0.85
# the runtime phase on the same nodes, in units of the deadline D and of the
# mean true block time m: a 1.5x slowdown of node b at 0.3 D, node c down
# at 0.5 D for 0.05 D, actuation latency 0.05 m and 1 J a switch, moves that
# take 0.1 m a block and 1 mJ a record, checkpoints every 0.25 m
RUNTIME = dict(fault_at=0.3, fault_factor=1.5, crash_at=0.5, repair=0.05,
               latency=0.05, switch_j=1.0, move_latency=0.1, move_j=1e-3,
               checkpoint=0.25)
# the serving mix over the plan's deadline: (name, process, jobs expected
# in D, SLO as a share of D or a multiple of m, priority)
TENANTS = (("steady", "poisson", 20, ("D", 1.0), 1.0),
           ("bursty", "burst", 10, ("D", 0.5), 2.0),
           ("tight", "poisson", 20, ("m", 4.0), 3.0))
BURST = dict(factor=5.0, start=0.4, end=0.6)
# fleet scale on the host: benchmarks/run.py:bench_engine's two sizes,
# (blocks, nodes, speed step)
FLEET_EQUIV = (10_000, 16, 0.02)
FLEET = (1_000_000, 100, 0.002)
FLEET_RING = 4096          # flight-recorder rows kept in (d)'s metrics runs
# run (b) again with the online re-planner's dead band (RuntimeConfig's
# replan_threshold, 0.15 in (b)) narrowed to each of these
REPLAN_SWEEP = (0.10, 0.05, 0.02)
# explain_miss's parts of a node's or a job's wall
MISS_KEYS = ("queueing_s", "cap_clamp_s", "crash_s", "migration_s",
             "slowdown_s", "actuation_s", "service_s")
MIXER_KERNEL = {"attn": "flash_attention", "mamba": "ssd_scan"}
# olmo-1b trained at full width: TrainConfig's batch and sequence defaults;
# a checkpoint at step 4 and 8 (keep 1), a node failure injected at step 6,
# so steps 4 and 5 run twice
TRAIN = dict(arch="olmo-1b", batch=8, seq_len=256, total_steps=8, warmup=2,
             ckpt_every=4, ckpt_keep=1, fail_at=6)
# mamba2-1.3b trained at full width: TrainConfig's batch and sequence
# defaults, 6 steps after the 3 calibration steps, no checkpoint
MAMBA_TRAIN = dict(arch="mamba2-1.3b", batch=8, seq_len=256, total_steps=6,
                   warmup=2)
# the backward kernels against autograd of the plain chunked version, as a
# share of each gradient's largest magnitude: both sum in float32, in other
# orders (32-row chunks against the model's 256, dB and dC over 64 heads,
# da_log over every token of the batch); the kernel's split, run on the CPU
# against the plain gradients, stays under 5e-6 of it.  Bfloat16 (x, B, C
# and dy; the flash kernels' tolerance): both sides sum in float32 and
# round each gradient to bfloat16 once (2 x 3.9e-3), plus the sum orders
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card against CPU at smoke size, float32 summed in other orders: the
# gradients as a share of each leaf's largest (a_log's and dt_bias's are
# sums over every token with cancellation: on smoke jamba's third layer the
# plain SSD on an H100 (700 W) is 6.9e-6 of its largest from the CPU, the
# kernel 1.09e-5), losses and norms relative, and the weights after two AdamW
# steps of lr 1e-3 absolute (AdamW moves every weight by about lr whatever
# its gradient's size, so a gradient near its eps moves by a visible share;
# a tenth of one step bounds that)
# the reference's train_4k cell (configs/shapes.py; launch/dryrun.py:53-70)
# in bfloat16 at the rows one card holds (launch/cell_memory.py:TRAIN_ROWS,
# reckoned from shapes): moments at cfg.opt_dtype, TRAIN_MICROBATCHES of the
# arch, four steps on one repeated batch (so the loss must fall)
# steps on one batch: olmo-1b's loss rises for two steps before it falls
# (PR 31's run), mamba2-1.3b's falls from the first, and its steps take 25 s
TRAIN_4K = dict(steps={"olmo-1b": 4, "mamba2-1.3b": 2}, seed=0)
# a step's device memory peak against cell_memory.reckon's (weights,
# moments and what the step makes, from shapes): within this many bytes
# either way (the allocator's rounding, cuBLAS' workspaces, the packed
# batch), and above it the SSD backward's float32 scratch too
# (ssd_scan.bwd_scratch_bytes), which the meta reckoning does not see
TRAIN_4K_PEAK_MARGIN = 2e9
SMOKE_GRAD_TOL = 5e-5
SMOKE_TRAIN_TOL = 1e-5
SMOKE_WEIGHT_TOL = 1e-4
# the reference's trainer tests at smoke size (tests/test_checkpoint_train.py
# :80-89): a failure at step 9 restores the checkpoint of step 8
TRAIN_SMOKE = dict(batch=2, seq_len=64, total_steps=12, ckpt_every=4,
                   warmup=2, seed=3, dvfs_enabled=False)
SMOKE_FAIL_AT = 9
DISK_MARGIN = 1.05
# the examples phase: train_lm at its 100m preset's full width, 30 steps
TRAIN_LM_ARGS = ["--preset", "100m", "--steps", "30"]
SERVE_LOGIT_TOL = 1e-3     # kernel vs chunked prefill, 16 float32 layers
# int8 KV cache against the float32 one, the first decode step's logits:
# K and V of each layer each within 1/254 of their row's largest value,
# the errors taken to add over the layers; this times the layers and the
# largest |logit| is the bound
INT8_LOGIT_TOL = 2 / 254
# prefill of S tokens vs prefill of S-1 and one decode step, 48 float32
# layers: the chunked scan against the recurrence, summed in other orders
CONTINUE_LOGIT_TOL = 1e-3
SMOKE_LOGIT_TOL = 1e-4     # card vs CPU at smoke size, float32
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}     # test_kernels.py
# the reference's sweep (tests/test_kernels.py:59-75) through ops.ssd_scan:
# (BH, S, P, N, chunk)
SSD_SWEEP = ((3, 128, 16, 32, 32), (3, 256, 32, 16, 64), (3, 64, 8, 8, 64))
# (label, B, S, H, G, P, N) in the model's layout, B/C strided views
SSD_CASES = (
    ("mamba2-1.3b heads 64/128", 2, 1024, 8, 1, 64, 128),
    ("jamba heads 128/128", 1, 512, 4, 1, 128, 128),
    ("grouped G=4, 8 heads a group", 1, 512, 32, 4, 64, 64),
    ("S=1000, partial last chunk", 2, 1000, 8, 1, 64, 128),
    ("P=8, head dim under one slice", 2, 300, 8, 2, 8, 16),
    ("S=40, under one chunk", 2, 40, 4, 1, 64, 128),
)
# (label, B, Hq, Hkv, S, D, causal, window); each in float32 and bfloat16
FLASH_CASES = (
    ("MHA 16/16 (olmo-1b heads)", 2, 16, 16, 1024, 128, True, None),
    ("GQA 32/4 (yi-6b heads)", 1, 32, 4, 1024, 128, True, None),
    ("GQA 8/1", 2, 8, 1, 1024, 64, True, None),
    ("SWA 256", 1, 8, 8, 1024, 64, True, 256),
    ("non-causal", 2, 4, 2, 512, 128, False, None),
    ("odd S=80 D=16", 1, 2, 2, 80, 16, True, None),
    ("SWA 48, under one tile", 1, 8, 2, 1024, 128, True, 48),
    ("S=1000, ragged last tiles", 2, 8, 8, 1000, 64, True, None),
)


# a rank of the four-card run collects its failed checks here and goes on,
# so that the ranks stay in step through their collectives; None (the
# one-card run) raises at the first
FAILED: list | None = None


def check(ok: bool, what: str) -> None:
    if not ok:
        if FAILED is not None:
            FAILED.append(what)
            print(f"  CHECK FAILED: {what}")
            return
        raise RuntimeError(f"chip_smoke: {what}")


def reset_launches() -> None:
    """Zero every kernel wrapper's launch count."""
    bs.reset_launches()
    fa.reset_launches()
    ss.reset_launches()


def launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {**bs.LAUNCHES, **fa.LAUNCHES, **ss.LAUNCHES}


def nvidia_smi(every: bool = False) -> str:
    """The first card's name and power limit as nvidia-smi gives them (with
    ``every``, every card's, one line each)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    lines = out.strip().splitlines()
    return "\n".join(lines) if every else lines[0]


def sync_seconds(fn):
    """(result, seconds) of ``fn()`` up to a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_card() -> tuple:
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    print(f"card: {name} | cc {cc[0]}.{cc[1]} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | nvidia-smi: {smi}")
    check(cc == (9, 0), f"the kernels are built for sm_90a, card is cc {cc}")
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matrix products would go through TF32")
    print("float32 matrix products in full float32: allow_tf32 False, "
          "precision 'highest'")
    return name, smi


def phase_build() -> None:
    for built in _build.build(bs.SOURCE, *fa.SOURCES.values(), ss.SOURCE,
                              ss.BWD_SOURCE):
        print(f"build: {built.seconds:.3f} s nvcc {' '.join(_build.NVCC_FLAGS)}"
              f" -> {built.path.relative_to(_build.BUILD_ROOT.parents[1])}")
        for line in built.log.splitlines():
            if "Compiling entry" in line or "Used" in line:
                print(f"ptxas: {line.strip()}")


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0


def compare_both_entries(label: str, toks: torch.Tensor, lengths, pattern,
                         exact_mass=None) -> dict:
    """Kernel vs plain on the card for both entries; exact agreement."""
    before = dict(bs.LAUNCHES)
    got = bs.block_stats_batched_cuda(toks, lengths, pattern)
    want = ref.block_stats_batched_ref(toks, lengths, pattern)
    err = {"block_stats_batched": _max_err(got, want)}
    check(err["block_stats_batched"] == 0.0,
          f"{label}: block_stats_batched differs from the plain version by "
          f"{err['block_stats_batched']}")
    if exact_mass is not None:
        check(np.array_equal(got[:, 2].cpu().numpy(), exact_mass),
              f"{label}: mass is not the exact int64 sum cast to float32")
    errs = []
    for b in range(toks.shape[0]):
        n = toks.shape[1] if lengths is None else \
            int(min(max(int(lengths[b]), 0), toks.shape[1]))
        one = bs.block_stats_cuda(toks[b, :n], pattern)
        errs.append(_max_err(one, ref.block_stats_ref(toks[b, :n], pattern)))
        errs.append(_max_err(one, got[b]))
    err["block_stats"] = max(errs, default=0.0)
    check(err["block_stats"] == 0.0,
          f"{label}: block_stats differs by {err['block_stats']}")
    nonempty = toks.numel() > 0
    check(bs.LAUNCHES["block_stats_batched"]
          == before["block_stats_batched"] + nonempty,
          f"{label}: block_stats_batched launch count")
    torch.cuda.synchronize()
    return err


def phase_parity() -> dict:
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in KERNELS}

    def case(label, toks, lengths=None, pattern=PATTERN, exact_mass=None):
        t = torch.as_tensor(toks, device=dev) if isinstance(toks, np.ndarray) \
            else toks
        err = compare_both_entries(label, t, lengths, pattern, exact_mass)
        for name, e in err.items():
            worst[name] = max(worst[name], e)
        print(f"parity ok: {label} {tuple(t.shape)}")

    toks = rng.integers(0, 50, (12, 300, 40)).astype(np.int32)
    lens = rng.integers(1, 301, 12)
    for b in range(12):
        toks[b, 0, :3] = PATTERN
        toks[b, lens[b]:, :3] = PATTERN          # poison the rows past length
    case("ragged lengths, poisoned pad rows", toks, lens)
    case("lengths=None", rng.integers(0, 50, (6, 64, 32)).astype(np.int32))
    one = rng.integers(0, 50, (1, 257, 48)).astype(np.int32)
    one[0, ::3, 5:8] = PATTERN
    case("n_blocks=1", one)
    case("R < tile", rng.integers(0, 50, (4, 3, 24)).astype(np.int32))
    case("L < p", np.full((3, 8, 2), 17, np.int32))
    short = rng.integers(0, 50, (5, 40, 16)).astype(np.int32)
    short[:, :, :3] = PATTERN
    case("lengths 0, above R and negative", short,
         np.array([0, 41, -3, 40, 7]))
    big = rng.integers(0, 32768, (4, 2048, 256)).astype(np.int32)
    exact = big.astype(np.int64).sum(axis=(1, 2)).astype(np.float32)
    check(bool(exact.min() > 2 ** 24), "mass case does not pass 2**24")
    case("ids to 32767, mass past 2**24", big, exact_mass=exact)
    base = torch.as_tensor(rng.integers(0, 30, (20, 33, 5)).astype(np.int32),
                           device=dev)
    view = base.permute(2, 1, 0)
    check(not view.is_contiguous(), "non-contiguous case is contiguous")
    case("non-contiguous", view, np.array([33, 10, 0, 5, 33]), (3, 4))
    overlap = np.full((2, 16, 30), 7, np.int32)
    overlap[1, ::2] = 0
    case("overlapping pattern", overlap, None, (7, 7))
    long_pat = tuple(range(1, 41))
    lp = rng.integers(0, 4, (3, 50, 64)).astype(np.int32)
    lp[:, ::3, 10:50] = long_pat
    case("40-token pattern", lp, np.array([50, 25, 1]), long_pat)
    # the redesign's edges: spans and toks[b, :n] views off 16-byte
    # boundaries, a row over many ring stages with the pattern across the
    # first stage boundary, more blocks than the persistent grid has
    # clusters, int64 lengths past the int32 range, a pattern longer than
    # the kernel keeps in shared memory
    odd = rng.integers(0, 50, (3, 37, 13)).astype(np.int32)
    odd[:, ::3, 1:4] = PATTERN
    case("odd L, int32 lengths", odd, np.array([37, 20, 1], np.int32))
    row = rng.integers(0, 50, (1, 1, 100000)).astype(np.int32)
    row[0, 0, 4094:4097] = PATTERN
    row[0, 0, 99997:] = PATTERN
    case("one 100000-token row", row)
    many = rng.integers(0, 50, (5000, 4, 8)).astype(np.int32)
    many[:, ::2, 1:4] = PATTERN
    case("5000 blocks of (4, 8)", many,
         rng.integers(-2, 6, 5000).astype(np.int32))
    case("int64 lengths of +-2**40", short[:4],
         np.array([2 ** 40, -2 ** 40, 3, 2 ** 40]))
    pat300 = tuple(range(1, 301))   # past the 256 kept in shared memory
    lp = rng.integers(0, 4, (2, 4, 700)).astype(np.int32)
    lp[:, ::2, 100:400] = pat300
    lp[1, 2, 399] = 0
    case("300-token pattern", lp, None, pat300)
    phase_parity_reuse(dev)
    phase_parity_cluster_16(rng, dev)

    before = dict(bs.LAUNCHES)
    for shape in ((0, 8, 8), (3, 0, 8), (2, 4, 0)):
        z = bs.block_stats_batched_cuda(
            torch.zeros(shape, dtype=torch.int32, device=dev))
        check(z.shape == (shape[0], 3) and not bool(z.any()),
              f"empty input {shape} does not give zeros")
    z1 = bs.block_stats_cuda(torch.zeros((0, 8), dtype=torch.int32,
                                         device=dev))
    check(z1.shape == (3,) and not bool(z1.any()), "empty single block")
    check(bs.LAUNCHES == before, "empty input launched a kernel")
    print("parity ok: empty inputs return zeros without a launch")
    return worst


def phase_parity_reuse(dev) -> None:
    """A block of 0 valid rows between full blocks reads back as zeros when
    its output lands on memory that held non-zero statistics."""
    host = np.random.default_rng(1).integers(1, 50, (3, 64, 32)).astype(
        np.int32)
    host[:, ::4, 1:4] = PATTERN
    toks = torch.as_tensor(host, device=dev)
    lens = torch.tensor([64, 0, 64], dtype=torch.int32, device=dev)
    first = bs.block_stats_batched_cuda(toks, None, PATTERN)
    torch.cuda.synchronize()
    check(bool((first != 0).all()), "reuse case: first call has zeros")
    ptr = first.data_ptr()
    del first
    got = bs.block_stats_batched_cuda(toks, lens, PATTERN)
    check(got.data_ptr() == ptr, "reuse case: the allocator moved the output")
    err = _max_err(got, ref.block_stats_batched_ref(toks, lens, PATTERN))
    check(err == 0.0 and not bool(got[1].any()),
          f"a block of 0 rows on reused memory reads {got[1].tolist()}")
    print("parity ok: a block of 0 valid rows on reused output memory")


def phase_parity_cluster_16(rng, dev) -> None:
    """One (2048, 256) block spread over a cluster of 16 CTAs."""
    facts = bs.occupancy(torch.cuda.current_device())
    shape = bs.launch_shape(1, 2048, 256, facts["slots"], facts["max_cluster"])
    check(shape == (16, 1), f"one block launches as {shape}, not (16, 1)")
    one = torch.as_tensor(rng.integers(0, 50, (2048, 256)).astype(np.int32),
                          device=dev)
    one[::5, 7:10] = torch.tensor(PATTERN, dtype=torch.int32, device=dev)
    err = _max_err(bs.block_stats_cuda(one, PATTERN),
                   ref.block_stats_ref(one, PATTERN))
    check(err == 0.0, f"cluster of 16 differs by {err}")
    print(f"parity ok: one block over a cluster of 16 ({facts['max_cluster']}"
          f" the card's largest; {facts['max_active_clusters']} such clusters"
          " at once)")


def _qkv(rng, b, hq, hkv, s, d, dtype):
    """q, k, v as the model hands them to the kernel: (B, H, S, D) views of
    (B, S, H, D) tensors, from seeded normal values."""
    return [torch.from_numpy(rng.normal(0, 1, (b, s, h, d)).astype(
        np.float32)).to("cuda", dtype).transpose(1, 2)
        for h in (hq, hkv, hkv)]


def flash_close(got: torch.Tensor, want: torch.Tensor, dtype) -> bool:
    """The reference's test: |got - want| <= tol + tol * |want|."""
    tol = FLASH_TOL[dtype]
    return bool(((got.double() - want.double()).abs()
                 <= tol + tol * want.double().abs()).all())


def phase_flash_parity(worst: dict) -> None:
    rng = np.random.default_rng(1)
    worst.setdefault("flash_attention", 0.0)
    for label, b, hq, hkv, s, d, causal, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(rng, b, hq, hkv, s, d, dtype)
            before = fa.LAUNCHES["flash_attention"]
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          swa_window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           swa_window=window)
            torch.cuda.synchronize()
            check(fa.LAUNCHES["flash_attention"] == before + 1,
                  f"flash {label}: launch count")
            check(got.dtype == dtype and got.shape == q.shape,
                  f"flash {label}: output {got.dtype} {tuple(got.shape)}")
            err = _max_err(got, want)
            tol = FLASH_TOL[dtype]
            check(flash_close(got, want, dtype),
                  f"flash {label} {dtype}: max |err| {err} over tol {tol}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
            print(f"flash parity ok: {label} B={b} S={s} D={d} "
                  f"{str(dtype)[6:]}: max |kernel - plain| {err:.3g} "
                  f"(tol {tol} abs + rel)")


def ssd_close(got: torch.Tensor, want: torch.Tensor, dtype) -> bool:
    """The reference's test: |got - want| <= tol + tol * |want|."""
    tol = SSD_TOL[dtype]
    return bool(torch.isfinite(got.float()).all()
                and ((got.double() - want.double()).abs()
                     <= tol + tol * want.double().abs()).all())


def ssd_inputs(rng, b, s, h, g, p, n, dtype):
    """x, dt, a_log, B, C as _run_ssd hands them to the kernel: x a reshape
    of (B, S, H*P), B and C strided slices of one (B, S, 2*G*N) tensor;
    seeded values in the reference test's ranges."""
    x = torch.from_numpy(rng.normal(0, 1, (b, s, h * p)).astype(
        np.float32)).to("cuda", dtype).reshape(b, s, h, p)
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (b, s, h)).astype(
        np.float32)).to("cuda")
    a_log = torch.from_numpy(rng.uniform(-1, 1, h).astype(np.float32)).to(
        "cuda")
    bc = torch.from_numpy(rng.normal(0, 1, (b, s, 2 * g * n)).astype(
        np.float32)).to("cuda", dtype)
    return (x, dt, a_log, bc[..., :g * n].reshape(b, s, g, n),
            bc[..., g * n:].reshape(b, s, g, n))


def ssd_naive(x, dt, a_log, b_mat, c_mat) -> torch.Tensor:
    """The naive recurrence in the model's layout: each head its own row,
    B/C repeated to it (only here, for the check)."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]

    def rows(t):                       # (B, S, H, D) -> (B*H, S, D)
        return t.transpose(1, 2).reshape(b * h, s, t.shape[-1])
    y = ref.ssd_scan_ref(
        rows(x), dt.transpose(1, 2).reshape(b * h, s), a_log.repeat(b),
        rows(b_mat.repeat_interleave(h // g, dim=2)),
        rows(c_mat.repeat_interleave(h // g, dim=2)))
    return y.reshape(b, h, s, p).transpose(1, 2)


def phase_ssd_parity(worst: dict) -> None:
    worst.setdefault("ssd_scan", 0.0)
    rng = np.random.default_rng(3)
    for bh, s, p, n, chunk in SSD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a_log, bm, cm = ssd_inputs(rng, 1, s, bh, bh, p, n, dtype)
            x, dt, bm, cm = (t[0].transpose(0, 1)     # (BH, S, ...) views
                             for t in (x, dt, bm, cm))
            before = ss.LAUNCHES["ssd_scan"]
            got = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk,
                               device="cuda")
            naive = ref.ssd_scan_ref(x, dt, a_log, bm, cm)
            torch.cuda.synchronize()
            check(ss.LAUNCHES["ssd_scan"] == before + 1,
                  f"ssd sweep {s}/{p}/{n}: launch count")
            err = _max_err(got, naive)
            check(got.dtype == dtype and got.shape == x.shape
                  and ssd_close(got, naive, dtype),
                  f"ssd sweep (BH,S,P,N)=({bh},{s},{p},{n}) {dtype}: max "
                  f"|err| {err} over tol {SSD_TOL[dtype]}")
            worst["ssd_scan"] = max(worst["ssd_scan"], err)
            print(f"ssd parity ok: ops.ssd_scan (BH,S,P,N)=({bh},{s},{p},{n})"
                  f" chunk {chunk} {str(dtype)[6:]}: max |kernel - naive| "
                  f"{err:.3g} (tol {SSD_TOL[dtype]} abs + rel)")
    for label, b, s, h, g, p, n in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(rng, b, s, h, g, p, n, dtype)
            before = ss.LAUNCHES["ssd_scan"]
            y, state = ss.ssd_scan_cuda(*args, final_state=True)
            want_y, want_state = ref.ssd_chunked_ref(*args, chunk=256)
            naive = ssd_naive(*args)
            torch.cuda.synchronize()
            check(ss.LAUNCHES["ssd_scan"] == before + 1,
                  f"ssd {label}: launch count")
            check(y.dtype == dtype and y.shape == args[0].shape
                  and state.shape == (b, h, p, n), f"ssd {label}: shapes")
            errs = {"y-chunked": _max_err(y, want_y),
                    "y-naive": _max_err(y, naive),
                    "state": _max_err(state, want_state)}
            for what, (got, want) in {"y-chunked": (y, want_y),
                                      "y-naive": (y, naive),
                                      "state": (state, want_state)}.items():
                check(ssd_close(got, want, dtype),
                      f"ssd {label} {dtype} {what}: max |err| {errs[what]} "
                      f"over tol {SSD_TOL[dtype]}")
            worst["ssd_scan"] = max(worst["ssd_scan"], errs["y-chunked"],
                                    errs["y-naive"])
            print(f"ssd parity ok: {label} (B,S,H,G,P,N)=({b},{s},{h},{g},"
                  f"{p},{n}) {str(dtype)[6:]}: max |err| " + ", ".join(
                      f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (tol {SSD_TOL[dtype]} abs + rel)")


def phase_zero_rows() -> None:
    """Each kernel wrapper on a batch of no rows (what a rank holds when a
    sharded batch has fewer rows than the ranks that split it): empty
    outputs of the right shapes and types, and empty gradients, with no
    launch counted.  Flash attention in both dtypes; the SSD scan's
    forward (y and the final state), through ``SsdScan`` with its
    backward, and ``ssd_scan_bwd_cuda`` called directly; block statistics
    on no blocks."""
    dev = torch.device("cuda")
    before = (dict(fa.LAUNCHES), dict(ss.LAUNCHES), dict(bs.LAUNCHES))
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((0, 4, 64, 64), dtype=dtype, device=dev)
        k = torch.zeros((0, 2, 64, 64), dtype=dtype, device=dev)
        out = fa.flash_attention_cuda(q, k, k)
        check(out.shape == q.shape and out.dtype == dtype
              and out.device.type == "cuda", f"flash {dtype} on 0 rows")
        x = torch.zeros((0, 64, 4, 64), dtype=dtype, device=dev,
                        requires_grad=True)
        dt = torch.zeros((0, 64, 4), device=dev, requires_grad=True)
        a_log = torch.zeros((4,), device=dev, requires_grad=True)
        bm = torch.zeros((0, 64, 2, 128), dtype=dtype, device=dev,
                         requires_grad=True)
        cm = torch.zeros_like(bm, requires_grad=True)
        ins = (x, dt, a_log, bm, cm)
        y, state = ss.ssd_scan_cuda(*ins, final_state=True)
        check(y.shape == x.shape and y.dtype == dtype
              and state.shape == (0, 4, 64, 128), f"ssd {dtype} on 0 rows")
        (y.float().sum() + state.sum()).backward()
        direct = ss.ssd_scan_bwd_cuda(*(t.detach() for t in ins),
                                      torch.zeros_like(y), None)
        for t, g in zip(ins, direct):
            for grad in (t.grad, g):
                check(grad is not None and grad.shape == t.shape
                      and grad.dtype == t.dtype and not bool(grad.any()),
                      f"ssd backward {dtype} on 0 rows: gradient shape "
                      f"{None if grad is None else tuple(grad.shape)}")
        n += 4
    z = bs.block_stats_batched_cuda(torch.zeros((0, 8, 8), dtype=torch.int32,
                                                device=dev))
    check(z.shape == (0, 3), "block statistics on no blocks")
    torch.cuda.synchronize()
    check((dict(fa.LAUNCHES), dict(ss.LAUNCHES), dict(bs.LAUNCHES))
          == before, "a wrapper launched a kernel on 0 rows")
    print(f"zero rows ok: {n + 1} wrapper calls (flash attention, the SSD "
          "scan forward, its backward through SsdScan and directly, in "
          "float32 and bfloat16; block statistics) return empty outputs "
          "and gradients, launching nothing")


def phase_main_path() -> dict:
    ds = BlockDataset(**MAIN)
    cfg = PipelineConfig(fraction=FRACTION, power=POWER)
    walls = dict.fromkeys(("generate", "estimate", "truth_stats", "plan"), 0.0)
    parts, truth = [], []
    first_chunk = None
    reset_launches()
    t_all = time.perf_counter()
    chunks = ds.iter_token_chunks(CHUNK, device="cuda")
    while True:
        item, dt = sync_seconds(lambda: next(chunks, None))
        walls["generate"] += dt
        if item is None:
            break
        start, toks = item
        est, dt = sync_seconds(lambda: token_chunk_estimates(
            toks, start_index=start, config=cfg, device="cuda"))
        walls["estimate"] += dt
        parts.append(est)

        def full_stats():
            stats = ops.block_stats_batched(toks, None, ds.grep_pattern,
                                            device="cuda")
            # one block again through the single-block entry, the per-block
            # cross-check the reference's benchmark makes
            probe = ops.block_stats(toks[0], ds.grep_pattern, device="cuda")
            check(torch.equal(probe, stats[0]),
                  f"block {start}: block_stats != block_stats_batched row")
            return token_cost(stats).cpu().numpy()
        tr, dt = sync_seconds(full_stats)
        walls["truth_stats"] += dt
        truth.append(tr)
        if first_chunk is None:
            first_chunk = toks
    est = EstimateArrays.concat(parts)
    truth = np.concatenate(truth)
    check(len(est) == MAIN["n_blocks"] and len(truth) == MAIN["n_blocks"],
          "main path lost blocks")
    check(bool(np.isfinite(est.total).all() and (est.total > 0).all()),
          "estimates are not finite and positive")
    check(bool(np.all(est.ci_low <= est.total)
               and np.all(est.total <= est.ci_high)), "CI does not hold total")
    k = int(est.n_sampled[0])
    ratio = float(est.total.sum() / truth.sum())
    print(f"main path: {MAIN['n_blocks']} blocks x {MAIN['records_per_block']}"
          f" records x {MAIN['max_len']} tokens in chunks of {CHUNK}; sampled "
          f"k={k} rows a block; sum(estimates)/sum(truth) = {ratio:.6f}")
    check(0.9 < ratio < 1.1, f"estimates off the truth by {ratio}")

    t0 = time.perf_counter()
    truth_blocks = [BlockInfo(int(i), float(t))
                    for i, t in zip(est.index, truth)]
    plans = []
    for slack in SLACKS:
        deadline = slack * float(truth.sum())
        dvo = simulate(plan_dvo(truth_blocks, deadline, power=POWER),
                       truth_blocks, power=POWER)
        for planner in ("paper", "global", "dvo"):
            if planner == "dvo":
                pa = plan_dvo_arrays(est.to_block_arrays(), deadline,
                                     power=POWER)
            else:
                pa = plan_estimates(est, deadline, PipelineConfig(
                    planner=planner, power=POWER))
            rep = simulate(pa.to_schedule_plan(), truth_blocks, power=POWER)
            plans.append((slack, planner, rep))
            print(f"  deadline {slack:.2f}x truth {planner:6s}: "
                  f"{rep.total_energy_j:.6f} J simulated, paper power model "
                  f"({100 * rep.improvement_vs(dvo):+.4f}% vs DVO), time "
                  f"{rep.total_time_s:.6f} s of {deadline:.6f} s, "
                  f"deadline_met={rep.deadline_met}")
    walls["plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    node_plans = plan_over_nodes(est, truth_blocks)
    walls["node_plan"] = time.perf_counter() - t0
    counts = launches()
    print(f"  launches in the main path: {json.dumps(counts)}")
    check(counts["flash_attention"] == 0 and counts["ssd_scan"] == 0,
          "the DV-DVFS path launched a serving kernel")
    for slack, planner, rep in plans:
        if slack == SLACKS[-1] and planner in ("paper", "global"):
            check(rep.deadline_met, f"{planner} misses the firm deadline")
    for name in bs.LAUNCHES:
        check(counts[name] > 0, f"main path never launched {name}")
    walls["total"] = time.perf_counter() - t_all
    print("  wall: " + ", ".join(f"{k} {v:.6f} s" for k, v in walls.items()))
    return {"launches": counts, "k": k, "first_chunk": first_chunk,
            "est": est, "truth_blocks": truth_blocks, "node_plans": node_plans}


def peak_power_w(cpa, util: np.ndarray) -> float:
    """The plan's conservative concurrent draw, as the planner's power
    screen counts it: every node at its own highest-power block, an empty
    node at idle."""
    total = 0.0
    for np_ in cpa.node_plans:
        pw = np_.node.power
        if not len(np_.plan.index):
            total += pw.p_idle
            continue
        draw = pw.p_idle + (pw.p_full - pw.p_idle) \
            * np.clip(util[np_.plan.index], 0.0, 1.0) \
            * np.clip(np_.plan.rel_freq, 0.0, 1.0) ** pw.alpha
        total += float(draw.max())
    return total


def at_fmax(plan):
    """``plan`` with every block at f_max: DVO on the same assignment."""
    return dataclasses.replace(plan, node_plans=tuple(
        dataclasses.replace(np_, blocks=tuple(
            dataclasses.replace(bp, rel_freq=1.0) for bp in np_.blocks))
        for np_ in plan.node_plans))


def main_nodes(truth_blocks: list) -> tuple:
    """The four nodes and the deadline of the main path's cluster."""
    nodes = [NodeSpec(name, speed=s) for name, s in zip("abcd", NODE_SPEEDS)]
    groups = assign_blocks(truth_blocks, nodes, strategy="round_robin")
    deadline = NODE_SLACK * max(sum(b.est_time_fmax for b in g) / nd.speed
                                for g, nd in zip(groups, nodes))
    return nodes, deadline


def plan_over_nodes(est: EstimateArrays, truth_blocks: list) -> dict:
    """The main path's estimates planned over four nodes
    (``plan_estimates(nodes=...)``), uncapped and then capped at CAP_SHARE
    of the uncapped plan's peak draw; each plan run against the truth
    beside DVO on the same assignment (simulate_cluster_reference)."""
    nodes, deadline = main_nodes(truth_blocks)
    util = est.to_block_arrays().util
    cap, out = None, {}
    for label in ("uncapped", "capped"):
        cpa = plan_estimates(est, deadline, PipelineConfig(power=POWER),
                             nodes=nodes, power_cap_w=cap)
        peak = peak_power_w(cpa, util)
        plan = cpa.to_cluster_plan()
        rep = simulate_cluster_reference(plan, truth_blocks)
        dvo = simulate_cluster_reference(at_fmax(plan), truth_blocks)
        saving = rep.improvement_vs(dvo)
        print(f"  over {len(nodes)} nodes (speeds {NODE_SPEEDS}), deadline "
              f"{deadline:.6f} s ({NODE_SLACK}x the largest round-robin f_max "
              f"time), {label}"
              + ("" if cap is None else f" at {cap:.3f} W ({CAP_SHARE} of the"
                 " uncapped peak)")
              + f": predicted makespan {cpa.pred_makespan_s:.6f} s, "
              f"feasible={cpa.feasible}, power_cap_ok={cpa.power_cap_ok}, "
              f"peak draw {peak:.3f} W; simulated against the truth: "
              f"makespan {rep.makespan_s:.6f} s, deadline_met="
              f"{rep.deadline_met}, {rep.total_energy_j:.6f} J "
              f"({100 * saving:+.4f}% vs DVO on the same assignment, "
              "TPU_V5E_POWER nodes)")
        check(all(np.isfinite(x) for x in (
            cpa.pred_makespan_s, cpa.pred_total_energy, peak, rep.makespan_s,
            rep.total_energy_j, dvo.total_energy_j)),
            f"the {label} node plan is not finite")
        if cap is not None and cpa.feasible:
            check(cpa.power_cap_ok and peak <= cap + 1e-9,
                  f"the capped plan draws {peak} W over its {cap} W cap")
        out[label] = {"makespan_s": rep.makespan_s, "feasible": cpa.feasible,
                      "power_cap_ok": cpa.power_cap_ok, "peak_w": peak,
                      "saving_vs_dvo": saving}
        cap = CAP_SHARE * peak
    return out


def as_cluster_report(rt) -> ClusterReport:
    """A ``RuntimeReport`` in the block-boundary loop's ``ClusterReport``
    form, as ``simulate_cluster`` returns it."""
    return ClusterReport(
        planner=rt.planner, deadline_s=rt.deadline_s,
        makespan_s=rt.makespan_s, total_energy_j=rt.total_energy_j,
        idle_energy_j=rt.idle_energy_j, deadline_met=rt.deadline_met,
        node_reports=tuple(NodeReport(nr.name, nr.busy_s, nr.energy_j,
                                      nr.n_blocks, nr.freqs)
                           for nr in rt.node_reports),
        n_replans=rt.n_replans)


def host_cpu() -> str:
    """The host's CPU as its first ``/proc/cpuinfo`` entry names it (a
    sandboxed kernel may report the model name as "unknown", so the vendor,
    family, model and clock come too) and the cores this process may use."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} "
            f"family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}, {info.get('cpu MHz', '?')} MHz), "
            f"{len(os.sched_getaffinity(0))} cores")


def fleet_scenario(n_blocks, n_nodes, speed_step):
    """The everything-on fleet scenario of the reference's engine benchmark
    (benchmarks/run.py:626-658, copied): faults, migration with wire
    energy, a power cap and online re-planning, from rng seed 0."""
    rng = np.random.default_rng(0)
    est = rng.uniform(0.2, 2.0, n_blocks)
    blocks = BlockArrays.build(
        est, util=rng.uniform(0.5, 1.0, n_blocks),
        records=rng.integers(100, 2000, n_blocks).astype(float))
    ladder = FrequencyLadder((0.6, 0.8, 1.0))
    nodes = [NodeSpec(f"n{k}", ladder=ladder,
                      power=PowerModel(p_idle=40.0, p_full=160.0,
                                       alpha=2.0),
                      speed=1.0 + speed_step * k)
             for k in range(n_nodes)]
    deadline = float(est.sum()) / n_nodes * 1.15
    events = [FaultEvent(time=deadline * 0.2, node="n3", factor=1.4),
              FaultEvent(time=deadline * 0.5, node="n7", factor=1.3)]
    cfg = RuntimeConfig(
        online=True, migrate=True, actuation=ActuationModel(),
        migration=MigrationModel(latency_s_per_block=1.0,
                                 energy_j_per_record=0.001),
        power_cap_w=n_nodes * 40.0 + 0.9 * n_nodes * 120.0,
        log_events=False)
    return blocks, nodes, deadline, events, cfg


def busy_by_freq(spans, node: str, since: float) -> dict:
    """Seconds ``node`` spent busy at each relative frequency from
    ``since`` on, off its block spans' constant-frequency segments."""
    out = collections.Counter()
    for s in spans.get(node, ()):
        if s.cat not in ("block", "crashed", "unfinished"):
            continue
        for seg in [c for c in s.children if c.cat == "freq"] or [s]:
            dur = seg.end - max(seg.start, since)
            if dur > 0.0:
                out[seg.get("freq", 1.0)] += dur
    return dict(sorted(out.items()))


def observe_run_b(rep, scenario: Scenario, deadline: float) -> None:
    """Run (b) through the fleet observatory: each node's wall split into
    its causes, the energy channels, one ablation per mechanism (its exact
    energy delta, makespan and deadline), the run diff against the
    ablation that moves the makespan most, the watchdog's alerts on a run
    with streamed metrics, and the Chrome-trace and Prometheus exports,
    each held to its validator."""
    spans = build_spans(rep.event_log)
    print(f"  (b) explain_miss per node: [0, finish] split into "
          f"{', '.join(MISS_KEYS)} (s); deadline {deadline!r} s")
    for nr in rep.node_reports:
        ex = explain_miss(rep, node=nr.name, spans=spans)
        total = math.fsum(ex[k] for k in MISS_KEYS)
        check(ex["wall_s"] == nr.finish_s
              and all(np.isfinite(ex[k]) for k in MISS_KEYS)
              and all(ex[k] >= 0.0 for k in MISS_KEYS if k != "service_s"),
              f"explain_miss of node {nr.name} is not a split of its wall")
        print(f"    {nr.name}: wall {ex['wall_s']!r}, missed={ex['missed']}, "
              f"over by {ex['wall_s'] - deadline:+.6f} s; "
              + ", ".join(f"{k} {ex[k]:.6f}" for k in MISS_KEYS)
              + f"; fsum {total!r} "
              f"{'==' if total == ex['wall_s'] else '!='} wall_s")
        faults = [e.time for e in scenario.events
                  if isinstance(e, FaultEvent) and e.node == nr.name]
        if ex["missed"] or faults:
            since = min(faults, default=0.0)
            print(f"      busy seconds by relative frequency from "
                  f"t={since:.6f} s: " + ", ".join(
                      f"{f} {s:.6f}" for f, s in busy_by_freq(
                          spans, nr.name, since).items()))
    energy = explain_energy(rep)
    print("  (b) explain_energy: " + ", ".join(
        f"{k} {v:.6f}" for k, v in energy.items()))

    rows = profile_mechanisms(scenario, engines=("vector",), base=rep)
    print("  (b) profile_mechanisms, each mechanism ablated (ablated minus "
          "base; vector engine):")
    print(format_table(rows, mechanism_columns(), indent="    "))
    ablations = {}
    for row in rows:
        if not row["changed"]:
            print(f"    {row['mechanism']}: already off in (b), identity "
                  "replay")
            continue
        abl = ablate(scenario, row["mechanism"], engines=("vector",))
        check(row["d_slack_s"] == (abl.deadline_s - abl.makespan_s)
              - (rep.deadline_s - rep.makespan_s),
              f"ablation {row['mechanism']}: its makespan disagrees with "
              "profile_mechanisms's row")
        ablations[row["mechanism"]] = abl
        print(f"    without {row['mechanism']}: makespan "
              f"{abl.makespan_s:.6f} s ({abl.makespan_s - rep.makespan_s:+.6f}"
              f" s), deadline_met={abl.deadline_met}, d_total_j "
              f"{row['d_total_j']:+.6f}, {abl.n_migrations} migrations, "
              f"peak {abl.peak_power_w:.3f} W")
    check(bool(ablations), "no mechanism of run (b) could be ablated")
    faster = [m for m, a in ablations.items() if a.makespan_s < rep.makespan_s]
    if len(faster) > 1:
        both = scenario
        for m in faster:
            both = neutralize(both, m)[0]
        joint = both.run(engine="vector")
        print(f"    without {' and '.join(faster)} together: makespan "
              f"{joint.makespan_s:.6f} s "
              f"({joint.makespan_s - rep.makespan_s:+.6f} s), deadline_met="
              f"{joint.deadline_met}, {joint.n_migrations} migrations, peak "
              f"{joint.peak_power_w:.3f} W")
    # the re-planner re-plans a node's tail only once its drift estimate
    # has moved by more than replan_threshold since the node's last re-plan
    cfg = scenario.config
    for thr in REPLAN_SWEEP:
        r = dataclasses.replace(scenario, config=dataclasses.replace(
            cfg, replan_threshold=thr)).run(engine="vector")
        print(f"    replan_threshold {thr} (not {cfg.replan_threshold}): "
              f"makespan {r.makespan_s:.6f} s "
              f"({r.makespan_s - rep.makespan_s:+.6f} s), deadline_met="
              f"{r.deadline_met}, {r.n_replans} replans, {r.n_migrations} "
              f"migrations, {r.total_energy_j:.6f} J busy "
              f"({r.total_energy_j - rep.total_energy_j:+.6f} J)")
    mover = max(ablations, key=lambda m: abs(ablations[m].makespan_s
                                             - rep.makespan_s))
    d = diff_runs(rep, ablations[mover])
    print(f"  (b) diff_runs against the ablation that moves the makespan "
          f"most ({mover}): d_makespan_s {d.totals['d_makespan_s']:+.6f}, "
          f"d_total_j {d.totals['d_total_j']:+.6f}; {len(d.blocks)} blocks "
          f"changed, {len(d.moved)} moved, {len(d.added)} added, "
          f"{len(d.dropped)} dropped; spans aligned {d.spans_aligned}")
    for row in d.nodes:
        print("    node " + ", ".join(
            f"{k} {v:+.6f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    for row in d.mechanisms:
        print(f"    mechanism {row}")

    mx = StreamingMetrics()
    wd = Watchdog(standard_rules(deadline)).attach(mx)
    watched = scenario.run(engine="vector", metrics=mx)
    check(watched == rep, "run (b) with streamed metrics differs from (b)")
    by_rule = collections.Counter(a.rule for a in wd.alerts)
    print(f"  (b) watchdog (standard_rules of the deadline): "
          f"{len(wd.alerts)} alerts, by rule {dict(by_rule)}; first: "
          + "; ".join(f"t={a.time:.3f} s [{a.severity}] {a.rule} burn "
                      f"{a.value:.3f}x" for a in wd.alerts[:3]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        path = Path(tmp) / "run_b.trace.json"
        doc = write_chrome_trace(path, rep)
        problems = validate_chrome_trace(doc) \
            + validate_chrome_trace(json.loads(path.read_text()))
        check(not problems, f"run (b)'s Chrome trace is invalid: "
              f"{problems[:5]}")
        sizes = {"trace": path.stat().st_size}
        for name, source in (("metrics", mx), ("report", rep)):
            prom = Path(tmp) / f"run_b.{name}.prom"
            prom.write_text(to_prometheus(source))
            problems = validate_prometheus(prom.read_text())
            check(not problems, f"run (b)'s Prometheus exposition of its "
                  f"{name} is invalid: {problems[:5]}")
            sizes[name] = prom.stat().st_size
    print(f"  (b) exports valid: Chrome trace {len(doc['traceEvents'])} "
          f"events ({sizes['trace']} bytes), Prometheus from the metrics "
          f"{sizes['metrics']} bytes and from the report {sizes['report']} "
          "bytes")


def observe_serving(sv) -> None:
    """Run (c)'s tenant rows, and the worst missed job's wall split into its
    causes, if a job missed."""
    print(format_table(tenant_rows(sv), [
        ("tenant", "tenant", "s"), ("arrived", "arrived", "d"),
        ("accepted", "accepted", "d"), ("rejected", "rejected", "d"),
        ("shed", "shed", "d"), ("finished", "finished", "d"),
        ("slo_miss", "slo_miss", "d"), ("miss_rate", "miss_rate", ".1%")],
        indent="    "))
    end = sv.runtime.makespan_s
    missed = [j for j in sv.jobs if not j.slo_met and j.status == "accepted"]
    if not missed:
        print(f"  (c) no accepted job missed its SLO "
              f"({sum(j.status == 'shed' for j in sv.jobs)} shed, "
              f"{sum(j.status == 'rejected' for j in sv.jobs)} rejected)")
        return
    worst = max(missed, key=lambda j: (j.t_finish if j.t_finish >= 0.0
                                       else end) - j.deadline_s)
    ex = explain_miss(sv, job_id=worst.job_id)
    check(all(np.isfinite(ex[k]) for k in MISS_KEYS),
          f"explain_miss of job {worst.job_id} is not finite")
    print(f"  (c) worst of {len(missed)} missed jobs: job {worst.job_id} "
          f"({worst.tenant}, {worst.status} on {worst.node or '-'}), wall "
          f"{ex['wall_s']:.6f} s, admission {ex['admission_s']:.6f} s; "
          + ", ".join(f"{k} {ex[k]:.6f}" for k in MISS_KEYS))


def fleet_metrics_overhead(fplan, blocks, fcfg, fevents, frep,
                           plain_s: float) -> None:
    """(d)'s largest fleet run again with a ``ring:N`` flight recorder, with
    and without ``StreamingMetrics`` fed inline, in turns (ring, metrics,
    metrics, ring): the instrumentation's host cost as the reference's CI
    guard defines it (metrics on against off, both under the ring), and
    the ring's own cost against the run with logging off (``plain_s``)."""
    walls = {"ring": [], "metrics": []}
    for kind in ("ring", "metrics", "metrics", "ring"):
        mx = StreamingMetrics() if kind == "metrics" else None
        cfg = dataclasses.replace(fcfg, metrics=mx, log_events=True,
                                  event_log=f"ring:{FLEET_RING}")
        rep, s = sync_seconds(lambda: run_cluster(
            fplan, blocks, config=cfg, events=fevents, engine="vector"))
        walls[kind].append(s)
        check(rep.makespan_s == frep.makespan_s
              and rep.total_energy_j == frep.total_energy_j,
              "(d) with a flight recorder differs from the plain run")
        check(len(rep.event_log) == FLEET_RING and rep.events_dropped > 0,
              f"(d)'s ring kept {len(rep.event_log)} rows")
        if mx is not None:
            fin = mx.snapshot()["counters"]["finishes"]
            check(fin == sum(nr.n_blocks for nr in rep.node_reports),
                  f"(d)'s metrics counted {fin} finishes")
    ring = sum(walls["ring"]) / 2
    with_mx = sum(walls["metrics"]) / 2
    print(f"  (d) ring:{FLEET_RING} flight recorder on the {len(blocks):,}-"
          f"block run, host walls: without metrics {walls['ring']} s, with "
          f"StreamingMetrics {walls['metrics']} s; metrics overhead "
          f"{100 * (with_mx / ring - 1):+.3f}% (means; the reference's CI "
          f"bound is +5% at 100,000 blocks), ring against logging off "
          f"({plain_s:.6f} s) {100 * (ring / plain_s - 1):+.3f}%; "
          f"{fin} finishes counted, {rep.events_dropped} log rows dropped")


def phase_runtime(main_path: dict) -> dict:
    """The main path's estimates (from the block_stats_batched kernel on
    the card) planned over its four nodes and executed by the event-driven
    runtime: (a) with zero actuation and no cap, bit for bit the
    block-boundary loop; (b) with online re-planning, migration, actuation,
    a cap, a slowdown and a transient crash, the vector engine against the
    scalar oracle, then read by the fleet observatory (``observe_run_b``);
    (c) the serving fabric on (b)'s plan under three tenants, with its
    tenant rows and worst missed job; (d) the reference benchmark's fleet
    scenario, and at 1,000,000 blocks the cost of streamed metrics.  All
    of it is host work: it launches no kernel."""
    est, truth_blocks = main_path["est"], main_path["truth_blocks"]
    produced = main_path["launches"]["block_stats_batched"]
    print(f"runtime: on the main path's {len(est)} estimates, made by "
          f"{produced} block_stats_batched launches on the card; host times "
          f"on {host_cpu()}")
    check(produced > 0, "the runtime's estimates came from no kernel launch")
    reset_launches()
    nodes, deadline = main_nodes(truth_blocks)
    cfg = PipelineConfig(power=POWER)
    truth = BlockArrays.from_blocks(truth_blocks)
    walls = {}

    # (a) zero actuation, no cap, offline: the block-boundary loop
    rep_a, walls["a_stream_run"] = sync_seconds(lambda: stream_run(
        est, deadline, cfg, nodes=nodes, truth=truth,
        runtime=RuntimeConfig(actuation=ActuationModel(latency_s=0.0,
                                                       switch_energy_j=0.0),
                              log_events=False)))
    plan_a = plan_estimates(est, deadline, cfg, nodes=nodes).to_cluster_plan()
    want, walls["a_reference_loop"] = sync_seconds(
        lambda: simulate_cluster_reference(plan_a, truth_blocks))
    check(as_cluster_report(rep_a) == want,
          "run (a) differs from simulate_cluster_reference")
    check(simulate_cluster(plan_a, truth_blocks) == want,
          "simulate_cluster differs from simulate_cluster_reference")
    print(f"  (a) stream_run, zero actuation, no cap: makespan "
          f"{rep_a.makespan_s:.6f} s of {deadline:.6f} s, deadline_met="
          f"{rep_a.deadline_met}, {rep_a.total_energy_j:.6f} J; equal to "
          "simulate_cluster_reference and to simulate_cluster, bit for bit")

    # (b) everything on, scalar oracle against the vector engine
    cap = CAP_SHARE * main_path["node_plans"]["uncapped"]["peak_w"]
    m = float(truth.est_time_fmax.mean())
    R = RUNTIME
    truth_b = dataclasses.replace(truth,
                                  records=est.n_records.astype(np.float64))
    events = (FaultEvent(time=R["fault_at"] * deadline, node="b",
                         factor=R["fault_factor"]),
              NodeFailureEvent(time=R["crash_at"] * deadline, node="c",
                               repair_s=R["repair"] * deadline))
    actuation = ActuationModel(latency_s=R["latency"] * m,
                               switch_energy_j=R["switch_j"])

    def runtime_b(power_cap_w=None):
        return RuntimeConfig(
            online=True, migrate=True, actuation=actuation,
            migration=MigrationModel(latency_s_per_block=R["move_latency"] * m,
                                     energy_j_per_record=R["move_j"]),
            recovery=RecoveryPolicy(
                checkpoint=CheckpointModel(interval_s=R["checkpoint"] * m)),
            power_cap_w=power_cap_w)
    rep_b, walls["b_stream_run"] = sync_seconds(lambda: stream_run(
        est, deadline, cfg, nodes=nodes, truth=truth_b, runtime=runtime_b(),
        events=events, power_cap_w=cap))
    cpa_b = plan_estimates(est, deadline, cfg, nodes=nodes, power_cap_w=cap)
    reps = {}
    for engine in ("scalar", "vector"):
        reps[engine], walls[f"b_{engine}"] = sync_seconds(
            lambda: run_cluster(cpa_b, truth_b, config=runtime_b(cap),
                                events=events, engine=engine))
    check(reps["scalar"] == reps["vector"]
          and reps["scalar"].event_log == reps["vector"].event_log,
          "run (b): the vector engine differs from the scalar oracle")
    check(rep_b == reps["vector"] and rep_b.event_log
          == reps["vector"].event_log, "run (b): stream_run differs from "
          "run_cluster on its plan")
    errs = check_conservation(reps["scalar"], cpa_b)
    check(not errs, f"run (b) breaks conservation: {errs}")
    check(rep_b.peak_power_w <= cap + 1e-9,
          f"run (b) draws {rep_b.peak_power_w} W over its {cap} W cap")
    check(rep_b.n_crashes == 1 and rep_b.n_repairs == 1,
          "run (b): the transient crash did not happen once")
    dvo = run_cluster(at_fmax(cpa_b.to_cluster_plan()), truth_b,
                      config=runtime_b(cap), events=events)
    saving = rep_b.improvement_vs(dvo)
    check(all(np.isfinite(x) for x in (rep_b.makespan_s,
                                       rep_b.total_energy_j,
                                       dvo.total_energy_j)),
          "run (b) is not finite")
    print(f"  (b) stream_run, online + migration + actuation "
          f"({actuation.latency_s:.6f} s, {actuation.switch_energy_j} J) + "
          f"cap {cap:.3f} W ({CAP_SHARE} of the uncapped peak), node b "
          f"x{R['fault_factor']} at {R['fault_at']} D, node c down at "
          f"{R['crash_at']} D for {R['repair']} D: makespan "
          f"{rep_b.makespan_s:.6f} s of {deadline:.6f} s, deadline_met="
          f"{rep_b.deadline_met}, {rep_b.total_energy_j:.6f} J "
          f"({100 * saving:+.4f}% vs DVO on the same assignment through the "
          f"runtime, {dvo.total_energy_j:.6f} J), peak "
          f"{rep_b.peak_power_w:.3f} W of {cap:.3f} W, "
          f"{rep_b.n_migrations} migrations, {rep_b.n_replans} replans, "
          f"{rep_b.n_switches} switches, "
          f"{len(rep_b.missed_blocks)} blocks missed, recoveries "
          f"{[d.action for d in rep_b.recoveries]}; scalar == vector, report"
          f" and {len(rep_b.event_log)} logged events; conservation holds")
    _, walls["b_obs"] = sync_seconds(lambda: observe_run_b(
        rep_b, Scenario(plan=cpa_b, truth=truth_b, config=runtime_b(cap),
                        events=events), deadline))

    # (c) the serving fabric on (b)'s plan under three tenants
    tenants = []
    for name, process, jobs, (unit, slo), prio in TENANTS:
        kw = {}
        if process == "burst":
            kw = dict(burst_factor=BURST["factor"],
                      burst_start_s=BURST["start"] * deadline,
                      burst_end_s=BURST["end"] * deadline)
        tenants.append(TenantSpec(
            name, rate_hz=jobs / deadline, priority=prio, process=process,
            slo_s=slo * (deadline if unit == "D" else m),
            blocks_per_job=(1, 3), block_time_s=(0.5 * m, 1.5 * m),
            records_per_block=float(MAIN["records_per_block"]), **kw))
    spec = ArrivalSpec(tenants=tuple(tenants), horizon_s=deadline,
                       seed=MAIN["seed"])
    served = {}
    for engine in ("scalar", "vector"):
        served[engine], walls[f"c_{engine}"] = sync_seconds(
            lambda: run_serving(cpa_b, truth_b, spec, engine=engine,
                                events=events[:1],
                                config=RuntimeConfig(online=True,
                                                     actuation=actuation,
                                                     power_cap_w=cap)))
    sv = served["scalar"]
    check(sv == served["vector"]
          and sv.event_log == served["vector"].event_log,
          "run (c): the vector engine differs from the scalar oracle")
    errs = check_serving_conservation(sv, cpa_b)
    check(not errs, f"run (c) breaks serving conservation: {errs}")
    check(len(sv.jobs) > 0, "run (c): no job arrived")
    print(f"  (c) run_serving on (b)'s plan (no crash), {len(sv.jobs)} jobs "
          f"over {deadline:.6f} s: " + "; ".join(
              f"{t.tenant} arrived {t.arrived}, accepted {t.accepted}, "
              f"rejected {t.rejected}, shed {t.shed}, finished {t.finished},"
              f" SLO misses {t.slo_miss}" for t in sv.tenants)
          + f"; makespan {sv.runtime.makespan_s:.6f} s, "
          f"{sv.runtime.total_energy_j:.6f} J; scalar == vector, report and "
          f"{len(sv.event_log)} logged events; conservation holds")
    observe_serving(sv)

    # (d) fleet scale on the host
    n, k, step = FLEET_EQUIV
    blocks, fnodes, fdeadline, fevents, fcfg = fleet_scenario(n, k, step)
    fplan, walls[f"d_plan_{n}"] = sync_seconds(lambda: plan_cluster_arrays(
        blocks, fnodes, deadline_s=fdeadline))
    freps = {}
    for engine in ("scalar", "vector"):
        freps[engine], walls[f"d_{engine}_{n}"] = sync_seconds(
            lambda: run_cluster(fplan, blocks, config=fcfg, events=fevents,
                                engine=engine))
    check(freps["scalar"] == freps["vector"],
          f"fleet {n} x {k}: the vector engine differs from the scalar one")
    print(f"  (d) fleet {n} blocks x {k} nodes: plan "
          f"{walls[f'd_plan_{n}']:.6f} s, scalar run "
          f"{walls[f'd_scalar_{n}']:.6f} s, vector run "
          f"{walls[f'd_vector_{n}']:.6f} s (host); equal reports, "
          f"{freps['vector'].n_migrations} migrations, deadline_met="
          f"{freps['vector'].deadline_met}")
    n, k, step = FLEET
    blocks, fnodes, fdeadline, fevents, fcfg = fleet_scenario(n, k, step)
    fplan, walls[f"d_plan_{n}"] = sync_seconds(lambda: plan_cluster_arrays(
        blocks, fnodes, deadline_s=fdeadline))
    frep, walls[f"d_vector_{n}"] = sync_seconds(lambda: run_cluster(
        fplan, blocks, config=fcfg, events=fevents, engine="vector"))
    check(np.isfinite(frep.makespan_s) and np.isfinite(frep.total_energy_j)
          and sum(nr.n_blocks for nr in frep.node_reports) == n,
          f"fleet {n} x {k} did not finish every block")
    check(frep.peak_power_w <= fcfg.power_cap_w + 1e-9,
          f"fleet {n} x {k} draws over its cap")
    print(f"  (d) fleet {n} blocks x {k} nodes: plan "
          f"{walls[f'd_plan_{n}']:.6f} s, vector run "
          f"{walls[f'd_vector_{n}']:.6f} s (host); makespan "
          f"{frep.makespan_s:.6f} s of {fdeadline:.6f} s, deadline_met="
          f"{frep.deadline_met}, {frep.n_migrations} migrations, peak "
          f"{frep.peak_power_w:.3f} W of {fcfg.power_cap_w:.3f} W")
    fleet_metrics_overhead(fplan, blocks, fcfg, fevents, frep,
                           walls[f"d_vector_{n}"])
    counts = launches()
    check(not any(counts.values()), f"the runtime launched kernels: {counts}")
    print("  host wall: " + ", ".join(f"{key} {v:.6f} s"
                                      for key, v in walls.items()))
    return {"walls": walls, "saving_vs_dvo": saving}


def phase_small_path() -> None:
    ds = BlockDataset(n_blocks=6, records_per_block=512, max_len=128, seed=3)
    cfg = PipelineConfig(fraction=FRACTION, power=POWER)
    card = stream_estimates_tokens(ds.iter_token_chunks(4, device="cuda"),
                                   cfg, device="cuda")
    cpu = stream_estimates_tokens(ds.iter_token_chunks(4, device="cpu"),
                                  cfg, device="cpu")
    check(np.array_equal(card.index, cpu.index)
          and np.array_equal(card.n_sampled, cpu.n_sampled),
          "card and CPU sample different rows")
    for key in ("total", "ci_low", "ci_high"):
        a, b = getattr(card, key), getattr(cpu, key)
        check(bool(np.allclose(a, b, rtol=1e-6, atol=0.0)),
              f"card and CPU {key} differ: {a} vs {b}")
    for planner in ("paper", "global"):
        for slack in SLACKS:
            deadline = slack * float(cpu.total.sum())
            pc = PipelineConfig(planner=planner, power=POWER)
            check(np.array_equal(plan_estimates(card, deadline, pc).rel_freq,
                                 plan_estimates(cpu, deadline, pc).rel_freq),
                  f"card and CPU {planner} plans differ at {slack}x")
    sc, sp = ds.stats_soa(4, device="cuda"), ds.stats_soa(4, device="cpu")
    check(all(np.array_equal(sc[key], sp[key]) for key in sc),
          "card and CPU stats_soa differ")
    print(f"small path on {ds.n_blocks} blocks: card == CPU (estimates within "
          "rtol 1e-6, sampled rows, stats, plan frequencies)")


def _app_outputs_agree(name, app, blk) -> None:
    card = app.run(blk, device="cuda")
    cpu = app.run(blk, device="cpu")
    if not isinstance(card, dict):
        card, cpu = {"out": card}, {"out": cpu}
    for key in card:
        a, b = card[key].cpu().numpy(), cpu[key].numpy()
        ok = np.allclose(a, b, rtol=1e-5, atol=0.0) if name in ("avg", "sum") \
            else np.array_equal(a, b)
        check(bool(ok), f"{name}.{key}: card and CPU differ")


def phase_apps() -> dict:
    """The five apps at the reference's block sizes (12 blocks each),
    through the port's ``examples.paper_figs``: each block and its 5%
    slice timed on the card (``measure_app``), then ``run_app_comparison``
    (affine calibration on 3 blocks, plan, simulate against DVO) from those
    times for the paper planner at the tight and firm slacks."""
    rows = {}
    for name in ex_bigdata_apps.APPS:
        kw = dict(paper_figs._APP_BLOCKS[name])
        with_tokens = kw.pop("with_tokens")
        ds = BlockDataset(n_blocks=12, variety_z=1.0, seed=0, **kw)
        b = ds.block(0, with_tokens=with_tokens)
        _app_outputs_agree(name, ALL_APPS[name](),
                           {key: b[key] for key in paper_figs._APP_KEYS[name]})
        times, t_sub = paper_figs.measure_app(name, sample_fraction=FRACTION,
                                              device="cuda")
        check(bool(np.isfinite(times).all() and (times > 0).all()),
              f"{name}: block times are not finite and positive")
        by_slack = {}
        for slack in SLACKS:
            by_slack[slack] = paper_figs.run_app_comparison(
                name, slack=slack, planner="paper", sample_fraction=FRACTION,
                power=POWER, device="cuda")
        firm = by_slack[SLACKS[-1]]
        row = {"ms_per_block": float(times.mean() * 1e3),
               "slice_ms": float(t_sub.mean() * 1e3),
               "cov": float(variety_stats(times).cov),
               "est_mape": firm["est_mape"],
               "saving_vs_dvo": firm["energy_improvement"],
               "deadline_met": bool(firm["deadline_met"]),
               "by_slack": by_slack}
        rows[name] = row
        print(f"app {name}: {ds.records_per_block} records a block, "
              f"{row['ms_per_block']:.6f} ms "
              f"a block (5% slice {row['slice_ms']:.6f} ms), CoV "
              f"{row['cov']:.6f}, estimate MAPE {row['est_mape']:.6f}, "
              f"simulated saving vs DVO {100 * row['saving_vs_dvo']:+.4f}% "
              f"(paper power model), deadline_met={row['deadline_met']}")
        for slack, r in by_slack.items():
            print(f"  {name} at slack {slack}: Δenergy "
                  f"{-r['energy_improvement']:+.6%}, Δtime "
                  f"{r['time_increase']:+.6%}, deadline_met="
                  f"{r['deadline_met']}, estimate error {r['est_mape']:.6f}")
    return rows


# the dry run's cells (arch, shape, multi-pod, microbatches or None for the
# production count), the longest first: DRYRUN_JOBS children at a time
# (arch, shape, multi-pod, microbatches or None for the production ones,
# the hillclimbed layouts of launch/optconfig.py)
DRYRUN_CELLS = (("olmo-1b", "train_4k", True, 16, False),
                ("olmo-1b", "prefill_32k", True, None, False),
                ("olmo-1b", "train_4k", False, None, False),
                ("qwen2-moe-a2.7b", "train_4k", True, 1, False),
                ("mamba2-1.3b", "train_4k", False, 1, False),
                ("olmo-1b", "train_4k", False, None, True),
                ("jamba-1.5-large-398b", "long_500k", False, None, False),
                ("olmo-1b", "long_500k", False, None, False),
                ("olmo-1b", "decode_32k", False, None, True))
DRYRUN_JOBS = 4
DRYRUN_TIMEOUT_S = 400
# olmo-1b prefill_32k multi-pod: 1,493,827,584 B when the cache is made at
# its shard; a shape helper once added a whole-batch K/V copy, (16, 16,
# 32768, 16, 128) bfloat16, 34.36 GB, and a partly sharded one would pass
# any limit far above the shard's.  The two train cells: about 1.25x their
# temp with the loss at each device's rows and vocab columns (olmo-1b
# 6,895,304,728 B, qwen2-moe-a2.7b 10,306,670,740 B, on torch 2.11 and
# 2.13); the loss's whole-microbatch logit gradient had made them
# 66,471,067,672 and 252,629,004,308 B
DRYRUN_TEMP_LIMIT = {("olmo-1b", "prefill_32k", "multi_pod"): 4e9,
                     ("olmo-1b", "train_4k", "single_pod"): 8.6e9,
                     ("qwen2-moe-a2.7b", "train_4k", "multi_pod"): 12.9e9}
# mamba2-1.3b train_4k: a device's FLOPs over benchmarks/counts.py's (B/C
# replicated over 'model', as in the reference, puts it above 1)
DRYRUN_FLOP_RATIO = {("mamba2-1.3b", "train_4k", "single_pod"): 1.2,
                     # 16 microbatches of 16 rows over the 32 batch ranks:
                     # one row on rank 0 (the reference's padded share,
                     # 16 of the 32 ranks holding a row, so about 1.9x);
                     # a 16-row microbatch over 'pod' alone put 8 rows on
                     # each device, about 15x
                     ("olmo-1b", "train_4k", "multi_pod"): 2.1}
# olmo-1b train_4k in the dp layout (opt): every gradient reduced once, by
# a reduce-scatter into its moments' shard, so the step all-reduces only
# scalars; this share of the float32 gradient's bytes is the limit (the
# norm's reductions over each mesh dim had all-reduced 10.24 GB a device,
# twice the bfloat16 gradient)
DRYRUN_OPT_AR_SHARE = 0.01
# (global shape, placements on a (pod 2, data 2, model 2) mesh): uneven
# splits, a dim split by two mesh dims, replicated dims
LOCAL_SHAPE_CASES = (((5, 7, 3), ("S0", "S0", "S1")),
                     ((3, 9), ("S1", "R", "S0")),
                     ((6, 4), ("R", "R", "R")),
                     ((1, 5, 2), ("S0", "S1", "S1")),
                     ((16, 3, 32, 4), ("S0", "S0", "S2")))


def check_local_shape() -> int:
    """``parallel.shards.local_shape`` (a shard's shape from shapes alone,
    which the dry run's meta cache uses) against DTensor's own
    ``distribute_tensor(...).to_local()`` on this torch, over a fake
    8-rank (pod 2, data 2, model 2) group as ranks 0, 3 and 6; returns the
    cases checked."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.parallel.shards import local_shape

    check(not dist.is_initialized(), "a process group is still running")
    n = 0
    for rank in (0, 3, 6):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = make_mesh({"pod": 2, "data": 2, "model": 2}, "cpu")
            for shape, names in LOCAL_SHAPE_CASES:
                pl = [Replicate() if p == "R" else Shard(int(p[1:]))
                      for p in names]
                want = tuple(distribute_tensor(
                    torch.empty(shape, device="meta"), mesh, pl,
                    src_data_rank=None).to_local().shape)
                got = local_shape(shape, mesh, pl)
                check(got == want, f"local_shape{shape, names} on rank "
                      f"{rank}: {got}, DTensor {want}")
                n += 1
        finally:
            dist.destroy_process_group()
    return n


def counts_flops(arch: str, shape: str, multi_pod: bool,
                 n_devices: int) -> float:
    """``benchmarks/counts.py``'s FLOPs a device of a dry-run cell, by
    ``tools/dryrun_breakdown.py:counts_terms`` (its formulas without the
    reference's imports)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from dryrun_breakdown import counts_terms
    from repro_torch.configs import SHAPES

    msd = ({"pod": 2} if multi_pod else {}) | {"data": 16, "model": 16}
    cell = SHAPES[shape]
    return sum(counts_terms(build_cfg(arch, msd, kind=cell.kind), cell,
                            n_devices).values())


def start_reckonings() -> tuple:
    """``cell_memory.reckon`` of each cell of ``phase_train_4k``, host work on
    meta tensors, started in processes of their own so that it runs beside
    the device's phases: (the pool, a future by arch)."""
    pool = concurrent.futures.ProcessPoolExecutor(
        len(cell_memory.TRAIN_ROWS),
        mp_context=torch.multiprocessing.get_context("spawn"))
    return pool, {arch: pool.submit(cell_memory.reckon, get_arch(arch),
                                    SHAPES["train_4k"], rows)
                  for arch, rows in cell_memory.TRAIN_ROWS.items()}


def start_dryrun() -> tuple:
    """The dry run's child processes (``phase_dryrun``), started
    ``DRYRUN_JOBS`` at a time on a thread pool: (pool, one future a cell
    of ``DRYRUN_CELLS`` with its exit code or None on a timeout, the
    records' directory, the start time)."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()

    def child(cell) -> int | None:
        arch, shape, mp, mb, opt = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape,
               "--out", os.path.join(out_dir, "opt" if opt else "base")]
        cmd += ["--multi-pod"] if mp else []
        cmd += ["--microbatches", str(mb)] if mb else []
        cmd += ["--opt"] if opt else []
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            # on a timeout the child is killed before this raises
            return subprocess.run(cmd, env=env, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL,
                                  timeout=max(left, 1.0)).returncode
        except subprocess.TimeoutExpired:
            return None

    pool = concurrent.futures.ThreadPoolExecutor(DRYRUN_JOBS)
    return pool, [pool.submit(child, c) for c in DRYRUN_CELLS], out_dir, t0


def phase_dryrun(started: tuple) -> list:
    """The dry run's records (``launch/dryrun.py``): olmo-1b train_4k on
    the single pod at its production two microbatches (the 16-rank 'data'
    axis split into microbatches), mamba2-1.3b train_4k (the SSD forward
    and backward on meta) and qwen2-moe-a2.7b train_4k on the multi-pod
    mesh at one microbatch, jamba long_500k, olmo-1b long_500k, which the
    reference skips, olmo-1b prefill_32k on the multi-pod mesh and olmo-1b
    train_4k there at 16 microbatches of 16 rows (fewer than the 32 batch
    ranks, so the hidden stream splits unevenly, one row on rank 0), after
    ``check_local_shape`` on this torch.  One child process a cell
    (``start_dryrun``): CPU work on meta tensors over a
    256/512-rank fake process group, which allocates nothing on the card.
    Each record's trace wall, FLOPs, collective bytes by kind and memory
    a device; every cell ok or the reference's skip; the olmo-1b
    prefill's temp below one
    whole-batch K or V copy (the cache counted at its shard), the olmo-1b
    and qwen2-moe-a2.7b trains' temp near their shards' (the loss on each
    device's rows and vocab columns), mamba2-1.3b's FLOPs at most 1.2x
    counts.py's (every tensor-parallel product at its shard) and the
    16-microbatch olmo-1b's at most 2.1x (a row a device).  Two cells in
    the reference's hillclimbed layouts (``--opt``): olmo-1b train_4k in
    the dp layout, whose all-reduces stay below ``DRYRUN_OPT_AR_SHARE`` of
    the float32 gradient (each gradient reduce-scattered once into its
    moments' shard), and olmo-1b decode_32k with the int8 KV cache.  No
    cell launches a kernel (``kernel_launches``: the SSD wrapper on meta
    counts its bound, never a launch).  The children run ``DRYRUN_JOBS``
    at a time beside the training phases (``phase_training``'s checkpoint
    I/O, then ``phase_train_4k``, whose steps keep the card over 99% busy,
    so its step walls are the device's); this waits for them before the
    production cells, whose decode steps the host bounds."""
    pool, futures, out_dir, t0 = started
    records = []
    try:
        n = check_local_shape()
        print(f"dry run: local_shape agrees with DTensor's distribute_tensor"
              f" in {n} cases (ranks 0, 3, 6 of a fake 8-rank group), torch "
              f"{torch.__version__}")
        rcs = [f.result() for f in futures]
        for (arch, shape, mp, mb, opt), rc in zip(DRYRUN_CELLS, rcs):
            check(rc is not None,
                  f"the dry run took over {DRYRUN_TIMEOUT_S} s")
            tag = f"{'mp' if mp else 'sp'}_{arch}_{shape}"
            path = os.path.join(out_dir, "opt" if opt else "base",
                                tag + ".json")
            tag += " opt" if opt else ""
            check(os.path.exists(path),
                  f"dry run {tag} exited {rc} and wrote no record")
            with open(path) as f:
                rec = json.load(f)
            records.append(rec)
            check(rc == 0 and rec["status"] != "failed",
                  f"dry run {tag} failed: {rec.get('error')}")
            if rec["status"] == "skipped":
                check(rec["reason"] == dryrun.SKIP_REASON,
                      f"dry run {tag}: skip reason {rec['reason']!r}")
                print(f"dryrun {tag}: skipped ({rec['reason']})")
                continue
            mem = rec["memory"]
            coll = rec["collective_bytes_per_device"]
            check(rec["flops_per_device"] > 0 and coll["total"] > 0
                  and mem["argument_bytes"] > 0,
                  f"dry run {tag}: an empty count")
            check(not any(rec["kernel_launches"].values()),
                  f"dry run {tag}: launched {rec['kernel_launches']} on "
                  "meta tensors")
            check(rec["opt"] == opt, f"dry run {tag}: opt {rec['opt']}")
            print(f"dryrun {tag}: {rec['n_devices']} devices, "
                  f"{rec['layout']} layout, {rec['microbatches']} "
                  f"microbatch(es), trace {rec['trace_s']} s; a device: "
                  f"{rec['flops_per_device']:.6e} FLOP, "
                  f"{rec['bytes_accessed_per_device']:.6e} bytes accessed "
                  f"(eager, unfused), collectives "
                  + ", ".join(f"{k} {v} B ({rec['collective_counts'][k]})"
                              for k, v in coll.items() if k != "total")
                  + f", total {coll['total']} B; memory argument "
                  f"{mem['argument_bytes']} B, output "
                  f"{mem['output_bytes']} B, temp {mem['temp_bytes']} B "
                  "(counts from shapes)")
            if opt and rec["kind"] == "train":
                grad = 4 * int(build_cfg(arch, {"data": 16, "model": 16},
                                         opt=True).param_count())
                print(f"dryrun {tag}: all-reduces {coll['all-reduce']} B, "
                      f"{coll['all-reduce'] / grad:.3e} of the float32 "
                      f"gradient's {grad} B")
                check(coll["all-reduce"] < DRYRUN_OPT_AR_SHARE * grad,
                      f"dry run {tag}: all-reduces {coll['all-reduce']} B, "
                      f"not below {DRYRUN_OPT_AR_SHARE} of the gradient")
                continue
            key = (arch, shape, rec["mesh"])
            if key in DRYRUN_TEMP_LIMIT:
                check(mem["temp_bytes"] < DRYRUN_TEMP_LIMIT[key],
                      f"dry run {tag}: temp {mem['temp_bytes']} B, not "
                      f"below {DRYRUN_TEMP_LIMIT[key]:.4g}")
            if key in DRYRUN_FLOP_RATIO:
                ratio = rec["flops_per_device"] / counts_flops(
                    arch, shape, mp, rec["n_devices"])
                print(f"dryrun {tag}: {ratio:.6f}x benchmarks/counts.py's "
                      "FLOPs a device")
                check(ratio <= DRYRUN_FLOP_RATIO[key],
                      f"dry run {tag}: {ratio:.4f}x counts.py's FLOPs, "
                      f"above {DRYRUN_FLOP_RATIO[key]}")
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"dry run: {len(records)} cells in "
          f"{time.perf_counter() - t0:.3f} s of host wall from their start "
          f"(one process a cell, {DRYRUN_JOBS} at a time, beside the "
          "training phases)")
    return records


class TimedEngine(ServingEngine):
    """The serving engine with the prefill's logits and wall and each
    window's wall recorded (each timed region ends in a synchronise)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.prefill_s = 0.0
        self.prefill_logits = None
        self.window_s: list = []

    def _prefill(self, prompts):
        t0 = time.perf_counter()
        logits, cache = super()._prefill(prompts)
        self._sync()
        self.prefill_s = time.perf_counter() - t0
        self.prefill_logits = logits
        self.prefill_launches = launches()
        return logits, cache

    def _window(self, n_steps, tok, cache):
        t0 = time.perf_counter()
        out = super()._window(n_steps, tok, cache)
        self._sync()
        self.window_s.append((n_steps, time.perf_counter() - t0))
        return out


def cache_bytes_per_token(cfg, batch: int, max_len: int) -> int:
    """The bytes a decode step moves through the layers' caches: the whole
    KV cache read for an attention layer (float32, or with ``kv_quant``
    int8 values and a float32 scale a row); the float32 SSM state and the
    conv caches each read and written for a Mamba layer."""
    total = 0
    row = cfg.d_head + 4 if cfg.kv_quant else 4 * cfg.d_head
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            total += 2 * batch * max_len * cfg.n_kv_heads * row
        else:
            sc = cfg.ssm
            state = batch * sc.n_heads * sc.head_dim * sc.d_state * 4
            conv = batch * (sc.d_conv - 1) * (sc.d_inner + sc.d_bc) * 4
            total += 2 * (state + conv)
    return total * cfg.n_repeats


def serve_roofline(cfg, batch: int, max_len: int, tokens: int
                   ) -> RooflineTimeModel:
    """A decode window's roofline on the H100: the model's decode FLOPs over
    the float32 rate, and the float32 weights read once a token plus each
    layer's cache traffic over the memory rate."""
    return RooflineTimeModel.from_counts(
        flops=tokens * T.model_flops(cfg, batch, max_len, mode="decode"),
        hbm_bytes=tokens * (4 * cfg.param_count()
                            + cache_bytes_per_token(cfg, batch, max_len)),
        coll_bytes=0, spec=H100)


def serve_run(sv: dict, cfg, kernel: str, describe: str) -> tuple:
    """The serving path at full width: random float32 weights from the
    seed, seeded prompts, the H100 window roofline; ``generate`` with every
    launch count zeroed just before and read just after.  Checks one
    ``kernel`` launch a layer, all of them in the prefill, and the outputs'
    shapes; returns (engine, prompts, output, counts, roofline, walls)."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    (params, init_s) = sync_seconds(lambda: T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(sv["seed"]),
        dtype=torch.float32, device=dev))
    n_params = sum(t.numel() for t in flatten(params).values())
    prompts = np.random.default_rng(sv["seed"]).integers(
        1, cfg.vocab, (sv["batch"], sv["prompt"])).astype(np.int32)
    roof = serve_roofline(cfg, sv["batch"], sv["max_len"], sv["window"])
    sc = ServeConfig(batch=sv["batch"], max_len=sv["max_len"],
                     window=sv["window"], planner="roofline",
                     slack=sv["slack"])
    eng = TimedEngine(cfg, params, sc, roofline=roof, device=dev)
    print(f"serving path: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {describe}, vocab {cfg.vocab}, {n_params} float32 "
          f"parameters (random, seed {sv['seed']}, init {init_s:.3f} s); "
          f"{sv['batch']} prompts x {sv['prompt']} tokens, {sv['n_tokens']} "
          f"new tokens, windows of {sv['window']}, slack {sv['slack']}")

    reset_launches()
    out, gen_s = sync_seconds(lambda: eng.generate({"tokens": prompts},
                                                   sv["n_tokens"]))
    counts = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches in the serving path: {json.dumps(counts)}")
    check(counts[kernel] == cfg.n_layers,
          f"the path launched {kernel} {counts[kernel]} times, not once a "
          f"layer ({cfg.n_layers})")
    check(counts == eng.prefill_launches and sum(counts.values())
          == counts[kernel], f"a kernel other than {kernel}, or one outside "
          "the prefill, was launched")

    toks = out["tokens"]
    check(tuple(toks.shape) == (sv["batch"], sv["n_tokens"] + 1),
          f"tokens of shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "tokens outside the vocab")
    check(out["n_generated"] == sv["n_tokens"] + 1, "n_generated")
    logits = eng.prefill_logits
    check(tuple(logits.shape) == (sv["batch"], cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "prefill logits are not finite of shape (B, V)")
    return eng, prompts, out, counts, roof, {"generate_s": gen_s,
                                             "peak_gb": peak_gb}


def prefill_mm_flops(cfg, params, tokens: int) -> int:
    """The prefill's matrix products: 2 FLOP a weight of the blocks for each
    row it multiplies; every token's row, except that a routed expert's
    weights multiply the rows of its dispatch buffer (G groups x the
    capacity, padding included)."""
    rows = {}
    if cfg.moe is not None:
        g = cfg.moe.dispatch_groups if tokens % cfg.moe.dispatch_groups == 0 \
            else 1
        rows = {"wi": g * MOE._capacity(tokens // g, cfg.moe)}
        rows["wg"] = rows["wo"] = rows["wi"]
    total = 0
    for blk in params["blocks"]:
        for key, t in flatten(blk).items():
            path = key.split(SEP)
            expert = len(path) > 1 and path[-2] == "moe" and path[-1] in rows
            total += 2 * (rows[path[-1]] if expert else tokens) * t[0].numel()
    return total * cfg.n_repeats


def serve_report(eng, sv: dict, out, roof, walls: dict) -> dict:
    """Print the prefill, window, decode, roofline and plan lines of a
    serving run; check the plan spends no more simulated energy than
    DVO."""
    cfg = eng.cfg
    windows = eng.window_s
    decoded = sum(n for n, _ in windows[1:])      # the timed windows
    decode_s = sum(w for _, w in windows[1:])
    freqs = [bp.rel_freq for bp in eng.plan.blocks]
    saving = 1 - out["energy"]["busy_j"] / out["energy_dvo"]["busy_j"]
    tokens = sv["batch"] * sv["prompt"]
    mm_flops = prefill_mm_flops(cfg, eng.params, tokens)
    print(f"  prefill wall {eng.prefill_s:.6f} s ({sv['batch']}x"
          f"{sv['prompt']} tokens: {tokens / eng.prefill_s:.1f} tokens/s; "
          f"{mm_flops} FLOP of the blocks' matrix products at "
          f"{mm_flops / eng.prefill_s / 1e12:.3f} TFLOP/s, {cfg.n_layers} "
          f"kernel launches inside); generate wall {walls['generate_s']:.6f}"
          f" s; peak device memory {walls['peak_gb']:.3f} GB")
    print("  window walls: " + ", ".join(
        f"{n} tok {w:.6f} s" for n, w in windows)
        + " (the first, one untimed step; the second, the f_max calibration)")
    print(f"  decode {decoded} steps x {sv['batch']} sequences in "
          f"{decode_s:.6f} s: {decoded * sv['batch'] / decode_s:.1f} tokens/s"
          f" ({1e3 * decode_s / decoded:.3f} ms a step)")
    print(f"  roofline of a window on the H100: t_comp "
          f"{roof.terms.t_comp:.6f} s, t_mem {roof.terms.t_mem:.6f} s "
          f"(bound: {roof.terms.dominant}; cache traffic "
          f"{cache_bytes_per_token(cfg, sv['batch'], sv['max_len'])} bytes a "
          f"token); plan ({eng.sc.planner}) frequencies {freqs}, DVO "
          f"{[bp.rel_freq for bp in eng.dvo_plan.blocks]}")
    print(f"  energy vs DVO, simulated with the copied TPU_V5E_POWER curve "
          f"(not the card's energy): {100 * saving:+.4f}% "
          f"(ledger steps {out['energy']['steps']})")
    check(saving >= -1e-9, "the plan spends more simulated energy than DVO")
    return {"prefill_s": eng.prefill_s, "windows": windows,
            "decode_tokens_per_s": decoded * sv["batch"] / decode_s,
            "saving": saving, **walls}


def phase_serving() -> dict:
    sv = SERVE
    cfg = get_arch(sv["arch"], attn_impl_train="pallas")
    eng, prompts, out, counts, roof, walls = serve_run(
        sv, cfg, "flash_attention", f"{cfg.n_heads}x{cfg.d_head} heads, d_ff "
        f"{cfg.d_ff}")
    logits = eng.prefill_logits
    chunked = cfg.replace(attn_impl_train="chunked")
    (want, cache), chunked_s = sync_seconds(lambda: T.prefill(
        eng.params, chunked, {"tokens": torch.as_tensor(prompts,
                                                        device="cuda")},
        sv["max_len"]))
    err = _max_err(logits, want)
    print(f"  prefill last logits, flash kernel vs plain chunked attention: "
          f"max |err| {err:.6g} (tol {SERVE_LOGIT_TOL}; |logits| up to "
          f"{float(want.abs().max()):.4f}); chunked prefill "
          f"{chunked_s:.6f} s")
    check(err <= SERVE_LOGIT_TOL, f"prefill logits differ by {err}")
    check(torch.equal(logits.argmax(-1), want.argmax(-1)),
          "first greedy tokens differ between kernel and chunked prefill")

    decode_profile(eng.params, cfg, want.argmax(-1).to(torch.int32)[:, None],
                   cache)
    return {"launches": counts, "logit_err": err,
            "tokens": out["tokens"].cpu(),
            **serve_report(eng, sv, out, roof, walls)}


def leaf_bytes(tree) -> int:
    """Bytes of every ``LeafShape`` in a shape tree."""
    return sum(math.prod(t.shape) * t.dtype.itemsize
               for t in flatten(tree).values() if isinstance(t, LeafShape))


def phase_int8_serving(float_run: dict) -> dict:
    """olmo-1b served at full width with the int8 KV cache (``kv_quant``,
    the reference's opt decode config) on the serving phase's traffic and
    weights (the same seed): one flash launch a layer, all in the prefill,
    none in decode (``serve_run``).  Then, on the same weights and prompts,
    the prefill's cache and the first decode step with the int8 cache
    against the float32 cache: every dequantized K and V element within
    half its row's scale (absmax / 127, rounded to the nearest step) of
    the float32 value, and the first decode step's logits within
    ``INT8_LOGIT_TOL``: each layer's K and V move by at most 1/254 of
    their row's largest value, and the error reaching the logits is taken
    to add over the layers, K and V each, with no cancellation.  The
    cache's bytes against the float32 cache's, decode time, peak memory,
    and the greedy tokens against the float32-cache run (the first step
    at which a sequence parts from it, and how many tokens differ;
    reported: random weights leave near-ties a rounding can flip)."""
    sv = SERVE
    cfg = get_arch(sv["arch"], attn_impl_train="pallas", kv_quant=True)
    plain = cfg.replace(kv_quant=False)
    q_bytes = leaf_bytes(T.cache_leaf_shapes(cfg, sv["batch"],
                                             sv["max_len"]))
    f_bytes = leaf_bytes(T.cache_leaf_shapes(plain, sv["batch"],
                                             sv["max_len"]))
    eng, prompts, out, counts, roof, walls = serve_run(
        sv, cfg, "flash_attention", f"int8 KV cache ({q_bytes} B, "
        f"float32 cache {f_bytes} B)")
    check(counts["flash_attention"] == cfg.n_layers
          and eng.prefill_launches == counts,
          f"int8 serving launched {counts}, not {cfg.n_layers} flash "
          "launches in the prefill and none in decode")
    report = serve_report(eng, sv, out, roof, walls)

    toks, ref = out["tokens"].cpu(), float_run["tokens"]
    differ = toks != ref
    parted = [int(torch.nonzero(row)[0]) if bool(row.any()) else None
              for row in differ]
    print(f"  int8 cache {q_bytes} B ({q_bytes / 1e9:.6f} GB: int8 values "
          f"and float32 row scales) against float32 {f_bytes} B "
          f"({f_bytes / q_bytes:.4f}x smaller); greedy tokens against the "
          f"float32-cache run: {int(differ.sum())} of {differ.numel()} "
          f"differ; first differing position by sequence (0 = the "
          f"prefill's token): {parted}")

    dev = torch.device("cuda")
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    with torch.no_grad():
        lf, cf = T.prefill(eng.params, plain, batch, sv["max_len"])
        lq, cq = T.prefill(eng.params, cfg, batch, sv["max_len"])
        check(torch.equal(lf, lq), "the int8 cache changed the prefill's "
              "logits")
        over = 0.0
        for blk_f, blk_q in zip(cf["blocks"], cq["blocks"]):
            for name in ("k", "v"):
                x = blk_f[name][:, :, :sv["prompt"]]
                sc = blk_q[name + "_s"][:, :, :sv["prompt"]]
                got = blk_q[name + "_q"][:, :, :sv["prompt"]].float() * sc
                # half a step, and float32's rounding of x / s and q * s
                lim = sc / 2 * (1 + 1e-5) + 1e-6 * x.abs()
                over = max(over, float(((got - x).abs() / lim).max()))
        nxt = lf.argmax(-1).to(torch.int32)[:, None]
        df, _ = T.decode_step(eng.params, plain, nxt, cf)
        dq, _ = T.decode_step(eng.params, cfg, nxt, cq)
    err = _max_err(dq, df)
    scale = float(df.abs().max())
    tol = INT8_LOGIT_TOL * cfg.n_layers * scale
    print(f"  int8 cache vs float32 after the prefill: the largest "
          f"dequantization error is {over:.6f} of its bound (half the "
          f"row's step, absmax / 254); first decode step's logits max "
          f"|err| {err:.6g} against the bound {tol:.6g} (2 x "
          f"{cfg.n_layers} layers x 1/254 of |logits| up to {scale:.6g}); "
          f"greedy tokens of that step equal: "
          f"{bool(torch.equal(dq.argmax(-1), df.argmax(-1)))}")
    check(over <= 1.0, f"an int8 cache element is {over:.4f}x its bound "
          "from the float32 value")
    check(bool(torch.isfinite(dq).all()) and err <= tol,
          f"int8-cache decode logits differ by {err}, bound {tol}")
    del cf, cq, eng
    free_device_memory()
    return {"cache_bytes": q_bytes, "float_cache_bytes": f_bytes,
            "decode_logit_err": err, "decode_logit_tol": tol,
            "tokens_differ": int(differ.sum()), "parted": parted, **report}


def decode_profile(params, cfg, tok, cache, top: int = 8) -> None:
    """One decode step at the serving shape, timed alone (after a warm-up
    step) and then traced (``step_profile``)."""
    def step():
        return T.decode_step(params, cfg, tok, cache)
    sync_seconds(step)                                    # warm-up
    _, step_s = sync_seconds(step)
    step_profile(step, step_s, f"decode step at position {cache['pos']}",
                 top)


def step_profile(fn, untraced_s: float, label: str, top: int = 8) -> tuple:
    """(``fn()``, device seconds or None) of one step ``fn`` (a decode
    step, a training microbatch) traced by torch.profiler; prints the
    device's busy share of ``untraced_s`` (its kernels' time over an
    untraced step's wall) and the ops whose kernels take the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, traced_s = sync_seconds(fn)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = 1e-6 * sum(e.self_device_time_total for e in kernels)
    if busy_s <= 0:
        print(f"  {label}: {untraced_s:.6f} s; device time not measured "
              "(the profiler recorded no CUDA kernels)")
        return out, None
    ops_ = [e for e in events if e.device_type == DeviceType.CPU
            and e.self_device_time_total > 0]
    print(f"  {label}: {untraced_s:.6f} s untraced ({traced_s:.6f} s "
          f"traced), {sum(e.count for e in kernels)} kernels; device busy "
          f"{busy_s:.6f} s = {100 * busy_s / untraced_s:.2f}% of the "
          f"untraced step (idle {100 * max(0.0, 1 - busy_s / untraced_s):.2f}"
          "%); ops by the device time of their kernels:")
    for e in sorted(ops_, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {1e-3 * e.self_device_time_total:10.3f} ms "
              f"{100e-6 * e.self_device_time_total / busy_s:6.2f}% "
              f"x{e.count:<4d} {e.key}")
    return out, busy_s


def phase_serving_cpu(arch: str, kernels: set, **overrides) -> None:
    """``arch`` at smoke size served on the card and on the CPU with the
    same weights and prompts: on the card one launch of each of ``kernels``
    for each layer whose mixer runs it, and no other kernel; none on the
    CPU; logits within SMOKE_LOGIT_TOL, equal greedy tokens."""
    cfg = smoke_config(arch, **overrides)
    mixers = [spec.mixer for spec in cfg.pattern] * cfg.n_repeats
    want = {name: sum(MIXER_KERNEL[m] == name for m in mixers)
            if name in kernels else 0 for name in launches()}
    check(all(want[name] for name in kernels),
          f"smoke {cfg.name} has no layer for one of {kernels}")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab, (2, 48)).astype(np.int32)
    sc = ServeConfig(batch=2, max_len=96, window=8, slack=1.2)
    outs = {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        eng = TimedEngine(cfg, params, sc, device=dev)
        out = eng.generate({"tokens": prompts}, 24)
        outs[dev] = (eng.prefill_logits.cpu(), out["tokens"].cpu())
        got = launches()
        check(got == (want if dev == "cuda" else dict.fromkeys(got, 0)),
              f"smoke {cfg.name} on {dev}: launches {got}, expected "
              f"{want if dev == 'cuda' else 'none'}")
    err = _max_err(outs["cuda"][0], outs["cpu"][0])
    print(f"smoke serving ({cfg.name} at smoke size, {cfg.n_layers} "
          f"layer(s), d_model {cfg.d_model}, through "
          f"{', '.join(f'{k} x{want[k]}' for k in sorted(kernels))}): card "
          f"vs CPU prefill logits max |err| {err:.3g} (tol "
          f"{SMOKE_LOGIT_TOL})")
    for b in range(2):
        print(f"  sequence {b} card: {outs['cuda'][1][b].tolist()}")
        print(f"  sequence {b} cpu:  {outs['cpu'][1][b].tolist()}")
    check(err <= SMOKE_LOGIT_TOL, f"card and CPU logits differ by {err}")
    check(torch.equal(outs["cuda"][1], outs["cpu"][1]),
          "card and CPU greedy tokens differ")


class RowRecorder:
    """A pass-through around a kernel wrapper ``fn`` that keeps the
    arguments and output of the calls numbered in ``keep``; with ``rows``,
    copies of those rows (dim 0) of every batched one (a_log, 1-D, whole)
    in place of the tensors.  It counts the bytes of the arguments at
    ``staged`` that the wrapper copies before its kernel
    (``fa.tma_ready``)."""

    def __init__(self, fn, keep, rows=None, staged=()):
        self.fn, self.keep, self.rows = fn, set(keep), rows
        self.staged = staged
        self.calls: dict = {}
        self.n = 0
        self.copied = 0

    def _pick(self, t):
        if isinstance(t, tuple):
            return tuple(self._pick(x) for x in t)
        if self.rows is not None and isinstance(t, torch.Tensor) \
                and t.dim() > 1:
            return t[list(self.rows)].clone()
        return t

    def __call__(self, *args, **kw):
        self.copied += sum(args[i].numel() * args[i].element_size()
                           for i in self.staged if not fa.tma_ready(args[i]))
        out = self.fn(*args, **kw)
        if self.n in self.keep:
            self.calls[self.n] = (self._pick(args), kw, self._pick(out))
        self.n += 1
        return out

    def held_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for call in self.calls.values()
                   for t in tree_leaves(call)
                   if isinstance(t, torch.Tensor))


def phase_mamba_serving() -> dict:
    sv = MAMBA_SERVE
    cfg = get_arch(sv["arch"])
    sc = cfg.ssm
    eng, prompts, out, counts, roof, walls = serve_run(
        sv, cfg, "ssd_scan", f"d_inner {sc.d_inner}, {sc.n_heads}x"
        f"{sc.head_dim} heads, d_state {sc.d_state}, {sc.n_groups} group")
    logits = eng.prefill_logits
    tprompts = torch.as_tensor(prompts, device="cuda")

    # the kernel against the plain chunked version on the real inputs of
    # the first and the last layer, recorded in a second prefill
    last = cfg.n_layers - 1
    rec = RowRecorder(ss.ssd_scan_cuda, (0, last))
    M.ssd_scan_cuda = rec
    try:
        again, _ = T.prefill(eng.params, cfg, {"tokens": tprompts},
                             sv["max_len"])
    finally:
        M.ssd_scan_cuda = ss.ssd_scan_cuda
    again_err = _max_err(again, logits)
    check(rec.n == cfg.n_layers and again_err <= SMOKE_LOGIT_TOL,
          f"a second prefill of the same prompts differs by {again_err}")
    layer_err = {}
    for i, (args, kw, (y, state)) in sorted(rec.calls.items()):
        want_y, want_state = ref.ssd_chunked_ref(*args, chunk=kw["chunk"])
        layer_err[i] = (_max_err(y, want_y), _max_err(state, want_state))
        print(f"  layer {i} SSD, kernel vs plain chunked on its real inputs: "
              f"y max |err| {layer_err[i][0]:.3g} (|y| up to "
              f"{float(want_y.abs().max()):.4g}), state max |err| "
              f"{layer_err[i][1]:.3g} (|state| up to "
              f"{float(want_state.abs().max()):.4g}); tol "
              f"{SSD_TOL[torch.float32]} abs + rel")
        check(ssd_close(y, want_y, torch.float32)
              and ssd_close(state, want_state, torch.float32),
              f"layer {i}: the kernel differs from the plain chunked SSD")
    del rec, again

    # the final state end to end: S-1 tokens of prefill, then one decode
    # step of the last token, against the S-token prefill's last logits
    _, cache = T.prefill(eng.params, cfg, {"tokens": tprompts[:, :-1]},
                         sv["max_len"])
    step, _ = T.decode_step(eng.params, cfg, tprompts[:, -1:], cache)
    cont_err = _max_err(step, logits)
    print(f"  continuation: prefill {sv['prompt'] - 1} tokens + decode token "
          f"{sv['prompt']} vs the {sv['prompt']}-token prefill: last logits "
          f"max |err| {cont_err:.6g} (tol {CONTINUE_LOGIT_TOL}; |logits| up "
          f"to {float(logits.abs().max()):.4f})")
    check(cont_err <= CONTINUE_LOGIT_TOL,
          f"decode after prefill differs from the prefill by {cont_err}")
    check(torch.equal(step.argmax(-1), logits.argmax(-1)),
          "greedy tokens differ between continuation and prefill")
    del cache, step

    _, cache = T.prefill(eng.params, cfg, {"tokens": tprompts},
                         sv["max_len"])
    decode_profile(eng.params, cfg, logits.argmax(-1).to(torch.int32)[:, None],
                   cache)
    return {"launches": counts, "layer_err": layer_err,
            "continuation_err": cont_err,
            **serve_report(eng, sv, out, roof, walls)}


ROUTE = MOE._route


RouteRecorder = mesh_checks.RouteRecorder


def recorded_prefill(params, cfg, tokens, max_len, flash=None, route=None):
    """``T.prefill`` with the recorders in place of the flash kernel's and
    the router's entries (restored afterwards)."""
    if flash is not None:
        ops.flash_attention_cuda = flash
    if route is not None:
        MOE._route = route
    try:
        return T.prefill(params, cfg, {"tokens": tokens}, max_len)
    finally:
        ops.flash_attention_cuda = fa.flash_attention_cuda
        MOE._route = ROUTE


def free_device_memory() -> None:
    """Drop what earlier phases left for the garbage collector and hand
    the caching allocator's free blocks back."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")


def phase_moe_serving() -> dict:
    free_device_memory()
    sv = MOE_SERVE
    cfg = get_arch(sv["arch"], attn_impl_train="pallas")
    m = cfg.moe
    tokens = sv["batch"] * sv["prompt"]
    cap = MOE._capacity(tokens, m)
    eng, prompts, out, counts, roof, walls = serve_run(
        sv, cfg, "flash_attention", f"{cfg.n_heads}x{cfg.d_head} heads, "
        f"{m.n_experts} routed experts of d_ff {m.d_ff_expert} at top-"
        f"{m.top_k} (capacity {cap} a expert over {tokens} tokens, factor "
        f"{m.capacity_factor}), {m.n_shared} shared (d_ff {m.d_ff_shared})")
    logits = eng.prefill_logits
    tprompts = torch.as_tensor(prompts, device="cuda")

    # a second prefill: the kernel against its plain version on the real
    # q/k/v of the first and the last layer, and the routes it took
    last = cfg.n_layers - 1
    flash = RowRecorder(fa.flash_attention_cuda, (0, last))
    kernel_routes = RouteRecorder()
    again = recorded_prefill(eng.params, cfg, tprompts, sv["max_len"],
                             flash, kernel_routes)[0]
    check(flash.n == cfg.n_layers and len(kernel_routes.routes)
          == cfg.n_layers, f"the second prefill made {flash.n} flash and "
          f"{len(kernel_routes.routes)} MoE calls")
    check(torch.equal(again, logits), "a second prefill of the same prompts "
          f"differs from the first by {_max_err(again, logits)}")
    print("  a second prefill of the same prompts: logits bit-identical to "
          "the first")
    layer_err = {}
    for i, ((q, k, v), kw, got) in sorted(flash.calls.items()):
        want = ref.flash_attention_ref(q, k, v, **kw)
        layer_err[i] = _max_err(got, want)
        print(f"  layer {i} attention, kernel vs plain on its real q/k/v "
              f"{tuple(q.shape)}: max |err| {layer_err[i]:.3g} (tol "
              f"{FLASH_TOL[torch.float32]}; |o| up to "
              f"{float(want.abs().max()):.4g})")
        check(flash_close(got, want, torch.float32),
              f"layer {i}: the flash kernel differs from its plain version")
    del again, flash

    # the same prompts through plain chunked attention: routes and logits
    chunked = cfg.replace(attn_impl_train="chunked")
    plain_routes = RouteRecorder()
    (want, cache), chunked_s = sync_seconds(lambda: recorded_prefill(
        eng.params, chunked, tprompts, sv["max_len"], route=plain_routes))
    flips = [(i, int((a[0] != b[0]).sum()), int((a[1] != b[1]).sum()))
             for i, (a, b) in enumerate(zip(kernel_routes.routes,
                                            plain_routes.routes))]
    n_route = sum(f[1] for f in flips)
    n_keep = sum(f[2] for f in flips)
    err = _max_err(logits, want)
    print(f"  prefill vs plain chunked attention ({chunked_s:.6f} s): "
          f"{n_route} of {cfg.n_layers * tokens * m.top_k} (layer, token, "
          f"slot) routes and {n_keep} keep flags differ, in layers "
          f"{[f[0] for f in flips if f[1] or f[2]]}; last logits max |err| "
          f"{err:.6g} (tol {SERVE_LOGIT_TOL} when no route differs; |logits| "
          f"up to {float(want.abs().max()):.4f})")
    if n_route == 0 and n_keep == 0:
        check(err <= SERVE_LOGIT_TOL, f"prefill logits differ by {err}")
        check(torch.equal(logits.argmax(-1), want.argmax(-1)),
              "first greedy tokens differ between kernel and chunked prefill")
    # no prefill-then-continue check here: with capacity drops a prefill of
    # S-1 tokens drops other slots than one of S, so the two prefills are
    # not the same function
    decode_profile(eng.params, cfg, want.argmax(-1).to(torch.int32)[:, None],
                   cache)
    del cache, want, kernel_routes, plain_routes
    report = serve_report(eng, sv, out, roof, walls)
    replicas = phase_moe_replicas(eng, sv, prompts, out, roof)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  peak device memory over the phase {peak_gb:.3f} GB")
    check(peak_gb < 80, f"the phase needed {peak_gb} GB")
    return {"launches": counts, "layer_err": layer_err, "route_flips": n_route,
            "keep_flips": n_keep, "logit_err": err, "replicas": replicas,
            **report, "phase_peak_gb": peak_gb}


def phase_moe_replicas(eng, sv: dict, prompts, single, roof) -> dict:
    """The same traffic over three replicas of different speeds under the
    shared SLO: replica 0 decodes on the card, the others are accounted
    from the cluster plan.  Checks the plan is feasible, the tokens are the
    single replica's, the slowest replica clocks at least as high as the
    fastest, and the simulated energy is within 1% of DVO's or below."""
    sc = ServeConfig(batch=sv["batch"], max_len=sv["max_len"],
                     window=sv["window"], planner="roofline", **REPLICAS)
    eng3 = TimedEngine(eng.cfg, eng.params, sc, roofline=roof,
                       device="cuda")
    out, gen_s = sync_seconds(lambda: eng3.generate({"tokens": prompts},
                                                    sv["n_tokens"]))
    cp = eng3.cluster_plan
    freqs = [[bp.rel_freq for bp in np_.blocks] for np_ in cp.node_plans]
    mean = [float(np.mean(f)) for f in freqs]
    busy, dvo = out["energy"]["busy_j"], out["energy_dvo"]["busy_j"]
    print(f"  {sc.replicas} replicas (speeds {sc.replica_speeds}, slack "
          f"{sc.slack}): generate wall {gen_s:.6f} s; plan feasible="
          f"{cp.feasible}; window frequencies "
          + "; ".join(f"replica {r} ({np_.node.speed}): {f}"
                      for r, (np_, f) in enumerate(zip(cp.node_plans, freqs)))
          + f"; energy vs DVO, simulated with the copied TPU_V5E_POWER curve "
          f"(not the card's energy): {100 * (1 - busy / dvo):+.4f}% (ledger "
          f"steps {out['energy']['steps']})")
    check(cp.feasible, "the replicas' plan is not feasible")
    check(torch.equal(out["tokens"], single["tokens"]),
          "the replicas' tokens differ from the single replica's")
    slow = int(np.argmin(sc.replica_speeds))
    fast = int(np.argmax(sc.replica_speeds))
    check(mean[slow] >= mean[fast], f"the slowest replica clocks at "
          f"{mean[slow]}, below the fastest's {mean[fast]}")
    check(busy <= dvo * 1.01, f"the replicas spend {busy} J against DVO's "
          f"{dvo} J")
    return {"feasible": cp.feasible, "mean_freq": mean,
            "saving": 1 - busy / dvo, "generate_s": gen_s}


class EventTrainer(Trainer):
    """The trainer with every call of its step timed by CUDA events on the
    card: the step alone, without the host's batch packing or the
    checkpoint I/O."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.step_events: list = []
        step_fn = self._step_fn

        def timed_step(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(*args)
            end.record()
            self.step_events.append((start, end))
            return out

        self._step_fn = timed_step

    def step_ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.step_events]


def run_example(name: str, fn) -> tuple:
    """``(result, wall)`` of one example run through ``fn``; what it
    printed is printed again, indented, and must hold no number that is
    not finite."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, wall = sync_seconds(fn)
    text = buf.getvalue()
    print(f"  {name}: wall {wall:.6f} s")
    for line in text.splitlines():
        print(f"    | {line}")
    check(re.search(r"\b(nan|inf)\b", text, re.IGNORECASE) is None,
          f"{name} printed a number that is not finite")
    return out, wall


def phase_examples() -> None:
    """The port's examples on the card, each through its entry point:
    cluster_sim, calibrate and quickstart at their defaults, serve_batch at
    its defaults on the H100's roofline, bigdata_apps at its defaults (its
    blocks timed on the card anew, not taken from ``phase_apps``'
    measurement; its numbers finite, its deadlines reported as they are),
    train_lm at its
    100m preset's full
    width for 30 steps (its steps timed by CUDA events, apart from the
    checkpoint I/O).  Each one's deadlines are met where the reference's
    text says they are."""
    free_device_memory()
    reset_launches()
    walls = {}
    out, walls["cluster_sim"] = run_example("cluster_sim", ex_cluster_sim.main)
    check(out["offline_demo"]["cluster"].deadline_met
          and not out["online_demo"]["static"].deadline_met
          and out["online_demo"]["online"].deadline_met
          and out["migration_demo"]["migration"].deadline_met
          and out["crash_recovery_demo"]["recovery"].deadline_met
          and out["overload_serving_demo"]["guarded"].accepted_miss_rate
          == 0.0 and len(out["counterfactual_demo"]["alerts"]) > 0,
          "cluster_sim: a deadline its text says is met was missed")
    out, walls["calibrate"] = run_example("calibrate", ex_calibrate.main)
    check(out["calibrated"].deadline_met and not out["default"].deadline_met,
          "calibrate: the calibrated plan did not recover the deadline")
    out, walls["quickstart"] = run_example(
        "quickstart", lambda: ex_quickstart.main(["--device", "cuda"]))
    res = out["training"]
    check(all(r.deadline_met for r in out["scheduler"].values())
          and np.isfinite(res["final_loss"])
          and res["final_loss"] < res["first_loss"]
          and res["energy"]["busy_j"] <= res["energy_dvo"]["busy_j"],
          "quickstart: a plan missed its deadline, or training did not "
          "learn or save")
    (out, eng), walls["serve_batch"] = run_example(
        "serve_batch", lambda: ex_serve_batch.main(["--device", "cuda"]))
    terms = eng.actuator.roofline.terms
    n_params = eng.cfg.param_count()
    check(terms.t_mem == 2 * n_params / H100.hbm_bw
          and terms.t_comp == 2 * n_params * eng.sc.batch / H100.peak_flops,
          "serve_batch did not plan on the H100's roofline")
    check(out["n_generated"] == 65 and out["energy"]["busy_j"]
          <= out["energy_dvo"]["busy_j"] * 1.001,
          "serve_batch generated the wrong count or saved nothing")

    paper_figs.clear_measurements()
    rows, walls["bigdata_apps"] = run_example(
        "bigdata_apps", lambda: ex_bigdata_apps.main(["--device", "cuda"]))
    for app, r in rows.items():
        check(all(np.isfinite(r[k]) for k in (
            "energy_improvement", "time_increase", "est_mape", "deadline_s",
            "dvfs_time_s", "dvfs_energy_j")),
              f"bigdata_apps: {app}'s numbers are not finite")
    print("  bigdata_apps deadline_met (reported as it is): "
          + ", ".join(f"{app} {r['deadline_met']}" for app, r in rows.items()))

    preset = TRAIN_LM_ARGS[TRAIN_LM_ARGS.index("--preset") + 1]
    n_steps = int(TRAIN_LM_ARGS[TRAIN_LM_ARGS.index("--steps") + 1])
    cfg, sizes = ex_train_lm.make_cfg(preset)
    n_params = int(cfg.param_count())
    ckpt_bytes = 12 * n_params         # float32 params and two moments
    trainers = []

    def event_trainer(*args, **kw):
        trainers.append(EventTrainer(*args, **kw))
        return trainers[-1]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as tmp:
        need = int(4 * ckpt_bytes * DISK_MARGIN)     # keep 3, 1 in flight
        free = shutil.disk_usage(tmp).free
        check(free >= need, f"{tmp} has {free / 1e9:.3f} GB free; train_lm "
              f"holds up to four {ckpt_bytes / 1e9:.3f} GB checkpoints")
        ck = os.path.join(tmp, "ck")
        res, walls["train_lm"] = run_example(
            "train_lm " + " ".join(TRAIN_LM_ARGS), lambda: ex_train_lm.main(
                TRAIN_LM_ARGS + ["--ckpt-dir", ck, "--device", "cuda"],
                trainer_cls=event_trainer))
        kept = sorted(os.listdir(ck))
        on_disk = sum(f.stat().st_size for d in Path(ck).iterdir()
                      for f in d.iterdir())
    tr = trainers[0]
    ms = tr.step_ms()
    n_cal = len(ms) - len(res["history"])
    run_ms = ms[n_cal:]
    hist = res["history"]
    check(len(hist) == n_steps and all(np.isfinite(h["loss"]) for h in hist)
          and res["final_loss"] < res["first_loss"],
          f"train_lm: the {n_steps} steps' losses are not finite or did not "
          "fall")
    tokens = sizes["batch"] * sizes["seq_len"]
    flops = T.model_flops(cfg, tokens, sizes["seq_len"])
    steps_s = sum(ms) / 1e3
    med = float(np.median(run_ms))
    print(f"  train_lm: {cfg.name} {preset} preset, {n_params} parameters "
          f"({cfg.n_layers} x {cfg.d_model}, vocab {cfg.vocab}), "
          f"{sizes['batch']} x {sizes['seq_len']} tokens a step; steps by "
          f"CUDA events: {n_cal} calibration "
          f"{[round(x, 3) for x in ms[:n_cal]]} ms, {n_steps} steps median "
          f"{med:.3f} ms (min {min(run_ms):.3f}, max {max(run_ms):.3f}), "
          f"{tokens / (med / 1e3):.0f} tokens/s, "
          f"{flops / (med / 1e3) / 1e12:.3f} TFLOP/s of model FLOPs (the steps"
          f" in order: {[round(x, 1) for x in run_ms]} ms); all "
          f"steps {steps_s:.6f} s of the {walls['train_lm']:.6f} s wall, the "
          f"rest ({walls['train_lm'] - steps_s:.6f} s) is initialisation, "
          f"batch packing and checkpoint I/O ({len(kept)} checkpoints kept, "
          f"{on_disk / 1e9:.3f} GB)")
    counts = launches()
    print(f"  kernel wrapper launches in the examples: {counts}; walls: "
          + ", ".join(f"{k} {v:.6f} s" for k, v in walls.items()))
    del res, tr, trainers, eng, out


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside, off after (the
    serving phases' MoE dispatch has ops without a deterministic kernel).
    cuBLAS needs CUBLAS_WORKSPACE_CONFIG, which ``main`` sets before the
    CUDA context is made."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


class TimedCheckpoints(CheckpointManager):
    """The trainer's checkpoint manager with, for each save, the wall of the
    device-to-host snapshot taken in ``save``, the wall up to the written
    checkpoint (the write runs on the manager's thread) and its bytes on
    disk, and for each restore, its wait for an in-flight write, the wall
    of its load onto the card and the device memory peak while it loads."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.saves: list = []
        self.restores: list = []

    def save(self, tree, step, extra=None):
        self.wait()
        rec = {"step": step, "t0": time.perf_counter()}
        self.saves.append(rec)
        super().save(tree, step, extra)
        rec["snapshot_s"] = time.perf_counter() - rec["t0"]

    def _gc(self):      # on the write thread, once the checkpoint is in place
        rec = self.saves[-1]
        rec["total_s"] = time.perf_counter() - rec["t0"]
        rec["bytes"] = sum(f.stat().st_size for f in
                           Path(self._ckpt_path(rec["step"])).iterdir())
        super()._gc()

    def restore_latest(self, like, *, device="cuda"):
        t0 = time.perf_counter()
        self.wait()
        wait_s = time.perf_counter() - t0
        restore = super().restore_latest
        torch.cuda.reset_peak_memory_stats()
        out, load_s = sync_seconds(lambda: restore(like, device=device))
        self.restores.append({"step": out[1] if out else None,
                              "wait_s": wait_s, "load_s": load_s,
                              "peak": torch.cuda.max_memory_allocated()})
        return out


class RecordingTrainer(Trainer):
    """The trainer with timed checkpoints; the wall and device memory peak
    of every call of its step (each wall from a synchronise to a
    synchronise, inside the trainer's own timing, on which it fits its
    cost model); and whether calibration left the weights equal to a host
    copy taken before it."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.ckpt = TimedCheckpoints(self.tc.ckpt_dir, keep=self.tc.ckpt_keep)
        self.calibration: dict = {}
        self.step_log: list = []
        step_fn = self._step_fn

        def timed_step(*args):
            torch.cuda.reset_peak_memory_stats()
            out, s = sync_seconds(lambda: step_fn(*args))
            self.step_log.append({"wall_s": s,
                                  "peak": torch.cuda.max_memory_allocated()})
            return out

        self._step_fn = timed_step

    def _calibrate_and_plan(self, params, opt_state):
        host = [t.cpu() for t in tree_leaves(params)]
        n = len(self.step_log)
        blocks = super()._calibrate_and_plan(params, opt_state)
        self.calibration = {
            "steps": self.step_log[n:],
            "unchanged": all(torch.equal(t.cpu(), h) for t, h in
                             zip(tree_leaves(params), host))}
        return blocks


def packed_batch(cfg, batch: int, seq_len: int) -> dict:
    """Block 0 of the trainer's default dataset, packed, on the card: its
    512 records of up to 128 tokens, or for a larger batch records enough
    to fill it (twice its tokens at 128 a record; they average 80)."""
    ds = BlockDataset(n_blocks=1,
                      records_per_block=max(512, 2 * batch * seq_len // 128),
                      max_len=128, vocab=cfg.vocab, seed=0)
    packed = pack_tokens(ds.block(0)["tokens"], batch, seq_len)
    tokens, labels = packed.tokens, packed.labels
    if cfg.n_codebooks:
        # a codebook model's K streams: the packed ids moved by k within
        # 1 .. vocab - 1 (padding and masked labels kept), stacked last
        k = np.arange(cfg.n_codebooks, dtype=np.int32)

        def move(ids):
            return np.where(ids[..., None] > 0,
                            (ids[..., None] - 1 + k) % (cfg.vocab - 1) + 1,
                            ids[..., None]).astype(np.int32)
        tokens, labels = move(tokens), move(labels)
    return {"tokens": torch.from_numpy(tokens).cuda(),
            "labels": torch.from_numpy(labels).cuda()}


def differing_grads(params, cfg, batch) -> list:
    """The gradient leaves that differ bit for bit between two identical
    ``loss_fn`` backward passes."""
    def grads():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = T.loss_fn(leaves, cfg, batch)
        return dict(zip(tree_flatten(leaves),
                        torch.autograd.grad(loss, tree_leaves(leaves))))
    a, b = grads(), grads()
    return [k for k in a if not torch.equal(a[k], b[k])]


def phase_training() -> None:
    """olmo-1b trained at full width through ``Trainer.run`` under the
    DV-DVFS plan: calibration, 8 steps, checkpoints at 4 and 8, a node
    failure at 6 restored from step 4, under deterministic algorithms, with
    no kernel wrapper launched (attention trains through ``chunked``)."""
    free_device_memory()
    tr = TRAIN
    cfg = get_arch(tr["arch"])
    check(cfg.attn_impl_train == "chunked" and cfg.remat
          and cfg.loss_chunk == 2048 and cfg.opt_dtype == "float32",
          f"{cfg.name} does not train as the reference's config does")
    n_params = int(cfg.param_count())    # exact for olmo-1b: no norm weights
    ckpt_bytes = 12 * n_params           # float32 params and two moments
    tokens = tr["batch"] * tr["seq_len"]
    flops = T.model_flops(cfg, tokens, tr["seq_len"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        free = shutil.disk_usage(tmp).free
        need = int(2 * ckpt_bytes * DISK_MARGIN)
        print(f"training: {cfg.name} at full width ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.n_heads}x{cfg.d_head} heads, "
              f"{cfg.mlp_kind} d_ff {cfg.d_ff}, vocab {cfg.vocab}, float32, "
              f"remat, attention {cfg.attn_impl_train}, loss chunk "
              f"{cfg.loss_chunk}), {n_params} parameters by param_count(); "
              f"checkpoints in {tmp}: {free / 1e9:.3f} GB free, "
              f"{need / 1e9:.3f} GB needed (two checkpoints of "
              f"{ckpt_bytes / 1e9:.3f} GB at once, +5%)")
        check(free >= need, f"{tmp} has {free / 1e9:.3f} GB free, but the "
              f"training phase holds two checkpoints of {ckpt_bytes / 1e9:.3f}"
              f" GB at once: run it with TMPDIR on a disk with "
              f"{need / 1e9:.3f} GB free")

        tc = TrainConfig(batch=tr["batch"], seq_len=tr["seq_len"],
                         total_steps=tr["total_steps"], warmup=tr["warmup"],
                         ckpt_every=tr["ckpt_every"],
                         ckpt_keep=tr["ckpt_keep"],
                         ckpt_dir=os.path.join(tmp, "ck"),
                         dvfs_enabled=True, planner="paper")
        with deterministic():
            trainer = RecordingTrainer(cfg, tc, device="cuda")
            reset_launches()
            res, run_s = sync_seconds(lambda: trainer.run(
                resume=False, inject_failure_at=tr["fail_at"]))
            counts = launches()
        training_report(trainer, res, cfg, tokens, flops, n_params, run_s)
        check(not any(counts.values()), f"training launched kernel "
              f"wrappers {counts}; attention trains through chunked")
        print(f"  kernel wrapper launches in the run: {counts} (attention "
              f"trains through the plain chunked route, as the reference's "
              f"attn_impl_train does, and olmo-1b has no Mamba layer)")
        del res, trainer
    free_device_memory()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = packed_batch(cfg, tr["batch"], tr["seq_len"])
    loose = differing_grads(params, cfg, batch)
    with deterministic():
        strict = differing_grads(params, cfg, batch)
    print(f"  two identical loss_fn backward passes at full width: "
          f"{len(loose)} of {len(tree_leaves(params))} gradient leaves "
          f"differ without deterministic algorithms {loose}, "
          f"{len(strict)} with them")
    check(not strict, f"gradients differ under deterministic algorithms: "
          f"{strict}")
    del params, batch
    phase_training_smoke()


class NoCheckpoints:
    """A checkpoint manager that writes nothing: ``Trainer.run`` saves at
    its last step, and olmo-1b's phase already measures checkpoint I/O."""

    def __init__(self):
        self.saves: list = []

    def save(self, tree, step, extra=None):
        self.saves.append(step)

    def wait(self):
        pass

    def restore_latest(self, like, *, device="cuda"):
        return None


class SsdGradRecorder:
    """A pass-through around the model's ``ssd_scan_cuda`` that keeps the
    inputs of the calls numbered in ``keep`` and, through a hook on y, the
    cotangent the backward pass brings it."""

    def __init__(self, keep):
        self.keep = set(keep)
        self.calls: dict = {}
        self.n = 0

    def __call__(self, *args, **kw):
        out = ss.ssd_scan_cuda(*args, **kw)
        if self.n in self.keep:
            rec = self.calls[self.n] = {"args": [a.detach() for a in args],
                                        "chunk": kw["chunk"]}
            out[0].register_hook(
                lambda g, rec=rec: rec.update(dy=g.detach()))
        self.n += 1
        return out


def grads_err(got, want) -> dict:
    """For each of (dx, ddt, da_log, dB, dC): max |got - want|, max |want|
    and whether the first is within SSD_BWD_TOL (of x's dtype) of the
    second, with each gradient in its input's dtype."""
    tol = SSD_BWD_TOL[got[0].dtype]
    out = {}
    for name, a, w in zip(("dx", "ddt", "da_log", "dB", "dC"), got, want):
        err, scale = _max_err(a, w), float(w.float().abs().max())
        out[name] = {"err": err, "scale": scale,
                     "ok": bool(torch.isfinite(w.float()).all())
                     and a.dtype == w.dtype and err <= tol * scale}
    return out


def fold_errs(acc: dict, dtype, errs: dict) -> None:
    """Fold ``grads_err``'s errors into ``acc`` under ``dtype``'s name: the
    largest max |err|, and the largest max |err| as a share of its
    gradient's max |grad|."""
    a = acc.setdefault(str(dtype)[6:], {"max_abs_err": 0.0,
                                        "max_rel_err": 0.0})
    for e in errs.values():
        a["max_abs_err"] = max(a["max_abs_err"], e["err"])
        a["max_rel_err"] = max(a["max_rel_err"],
                               e["err"] / e["scale"] if e["scale"]
                               else e["err"])


def phase_mamba_training() -> dict:
    """mamba2-1.3b trained at full width through ``Trainer.run`` (DV-DVFS
    calibration and plan, no checkpoint), each Mamba layer's SSD through the
    ``ssd_scan`` kernel and its backward kernels; then one more backward
    with the first and last layers' SSD inputs and cotangents recorded,
    their five gradients held against the plain version's; then one
    bfloat16 backward at full width (``mamba_bf16_backward``); then the
    backward kernels timed in both dtypes."""
    free_device_memory()
    tr = MAMBA_TRAIN
    cfg = get_arch(tr["arch"])
    sc = cfg.ssm
    check(cfg.remat and cfg.loss_chunk == 2048 and cfg.opt_dtype == "float32"
          and cfg.n_layers == 48 and cfg.d_model == 2048,
          f"{cfg.name} does not train as the reference's config does")
    n_params = int(cfg.param_count())
    tokens = tr["batch"] * tr["seq_len"]
    flops = T.model_flops(cfg, tokens, tr["seq_len"])
    print(f"Mamba training: {cfg.name} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {sc.n_heads}x{sc.head_dim} heads, d_state "
          f"{sc.d_state}, {sc.n_groups} group, vocab {cfg.vocab}, float32, "
          f"remat, loss chunk {cfg.loss_chunk}), {n_params} parameters by "
          f"param_count(); {tr['batch']} x {tr['seq_len']} tokens a step; "
          "Trainer.run with DV-DVFS calibration and plan, its checkpoint "
          "manager one that writes nothing")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mamba_") as tmp, \
            deterministic():
        tc = TrainConfig(batch=tr["batch"], seq_len=tr["seq_len"],
                         total_steps=tr["total_steps"], warmup=tr["warmup"],
                         ckpt_dir=os.path.join(tmp, "ck"), dvfs_enabled=True,
                         planner="paper")
        trainer = RecordingTrainer(cfg, tc, device="cuda")
        trainer.ckpt = NoCheckpoints()
        reset_launches()
        res, run_s = sync_seconds(lambda: trainer.run(resume=False))
        counts = launches()
    hist = res["history"]
    n_steps = len(trainer.step_log)          # calibration's and the run's
    losses = [h["loss"] for h in hist]
    peak = max(r["peak"] for r in trainer.step_log)
    print(f"  Trainer.run wall {run_s:.3f} s, {n_steps} steps (3 of "
          f"calibration); launches {json.dumps(counts)}; peak device memory "
          f"in a step {peak / 1e9:.3f} GB; calibration left the weights "
          f"as they were: {trainer.calibration['unchanged']}")
    for h, r in zip(hist, trainer.step_log[3:]):
        print(f"    step {h['step']}: loss {h['loss']:.6f}, wall "
              f"{h['wall_s']:.6f} s, {tokens / h['wall_s']:.1f} tokens/s, "
              f"{flops / h['wall_s'] / 1e12:.3f} model TFLOP/s "
              f"({flops * 4 / 3 / h['wall_s'] / 1e12:.3f} with remat), peak "
              f"{r['peak'] / 1e9:.3f} GB, rel_freq {h['rel_freq']}")
    check(len(hist) == tr["total_steps"] and all(np.isfinite(losses)),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(trainer.calibration["unchanged"], "calibration changed the weights")
    check(peak < 80e9, f"a step needed {peak / 1e9:.3f} GB")
    want = dict.fromkeys(counts, 0)
    want.update(ssd_scan=2 * cfg.n_layers * n_steps,
                ssd_scan_bwd=cfg.n_layers * n_steps)
    check(counts == want, f"the run launched {counts}, expected {want}: the "
          "SSD twice a layer a step (the forward, and remat's recomputation "
          "in the backward), its backward once")

    # one more backward, the first and last layers' SSD recorded
    last = cfg.n_layers - 1
    rec = SsdGradRecorder((0, last))
    batch = packed_batch(cfg, tr["batch"], tr["seq_len"])
    leaves = tree_map(lambda t: t.detach().requires_grad_(), res["params"])
    del res, trainer
    M.ssd_scan_cuda = rec
    try:
        reset_launches()
        loss, _ = T.loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        step_counts = launches()
    finally:
        M.ssd_scan_cuda = ss.ssd_scan_cuda
    del grads, leaves
    print(f"  one loss_fn backward: launches {json.dumps(step_counts)} "
          f"({rec.n} ssd_scan calls: {cfg.n_layers} in the forward, "
          f"{rec.n - cfg.n_layers} in remat's recomputation)")
    check(step_counts["ssd_scan"] == 2 * cfg.n_layers == rec.n
          and step_counts["ssd_scan_bwd"] == cfg.n_layers,
          f"one backward launched {step_counts}")
    fwd_worst = 0.0
    by_dtype = {}
    layer_err = {}
    for i, call in sorted(rec.calls.items()):
        check("dy" in call, f"layer {i}'s SSD got no cotangent")
        args, dy = call["args"], call["dy"]
        with torch.no_grad():
            fwd = ss.ssd_scan_cuda(*args, chunk=call["chunk"],
                                   final_state=True)
        want_f = ref.ssd_chunked_ref(*args, chunk=call["chunk"])
        y_err, state_err = (_max_err(a, w) for a, w in zip(fwd, want_f))
        fwd_err = max(y_err, state_err)
        fwd_worst = max(fwd_worst, fwd_err)
        print(f"  layer {i} SSD forward, kernel vs the plain chunked version "
              f"on its real inputs: max |err| y {y_err:.3g}, state "
              f"{state_err:.3g} (tol {SSD_TOL[torch.float32]} abs + rel)")
        check(all(ssd_close(a, w, torch.float32) for a, w in zip(fwd, want_f)),
              f"layer {i}: the forward kernel differs from the plain chunked "
              f"version by {fwd_err}")
        del fwd, want_f
        got = ss.ssd_scan_bwd_cuda(*args, dy, None)
        want_g = ref.ssd_chunked_bwd_ref(*args, dy, None, chunk=call["chunk"])
        errs = layer_err[i] = grads_err(got, want_g)
        fold_errs(by_dtype, torch.float32, errs)
        print(f"  layer {i} SSD backward, kernel vs autograd of the plain "
              f"chunked version on its real inputs and cotangent: "
              + ", ".join(f"{k} {e['err']:.3g} of {e['scale']:.4g}"
                          for k, e in errs.items())
              + " (max |err| of max |grad|; tol "
              f"{SSD_BWD_TOL[torch.float32]} of it)")
        check(all(e["ok"] for e in errs.values()),
              f"layer {i}: the backward kernels differ from the plain "
              f"gradients: {errs}")
    del rec, batch
    free_device_memory()
    bf16 = mamba_bf16_backward(cfg, tr)
    for errs in bf16["layer_err"].values():
        fold_errs(by_dtype, torch.bfloat16, errs)
    free_device_memory()
    times = ssd_bwd_times(sc, by_dtype)
    return {"launches": counts, "steps": n_steps, "per_step": step_counts,
            "losses": losses, "peak_gb": peak / 1e9, "run_s": run_s,
            "layer_err": layer_err, "fwd_max_abs_err": fwd_worst,
            "bf16": bf16, **times}


def mamba_bf16_backward(cfg, tr) -> dict:
    """mamba2-1.3b at full width in bfloat16 (``T.init_params(cfg,
    dtype=torch.bfloat16)``, as the dry run's train cells lay it out): one
    ``loss_fn`` backward on a training step's batch, each layer's SSD
    backward through the bfloat16 kernels; layers 0 and 47's five gradients
    against the plain version's bfloat16 gradients on the same inputs and
    cotangent, its launches and peak."""
    last = cfg.n_layers - 1
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16, device="cuda")
    leaves = tree_map(lambda t: t.requires_grad_(), params)
    batch = packed_batch(cfg, tr["batch"], tr["seq_len"])
    rec = SsdGradRecorder((0, last))
    M.ssd_scan_cuda = rec
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        (loss, _), fwd_s = sync_seconds(lambda: T.loss_fn(leaves, cfg, batch))
        grads, bwd_s = sync_seconds(lambda: torch.autograd.grad(
            loss, tree_leaves(leaves)))
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        M.ssd_scan_cuda = ss.ssd_scan_cuda
    finite = all(bool(torch.isfinite(g.float()).all()) for g in grads)
    del grads, leaves, params
    print(f"  bfloat16 mamba2-1.3b ({cfg.n_layers} layers, weights in "
          f"bfloat16), one loss_fn backward on {tr['batch']} x "
          f"{tr['seq_len']} tokens: loss {float(loss.detach()):.6f}, "
          "forward "
          f"{fwd_s:.3f} s, backward {bwd_s:.3f} s, launches "
          f"{json.dumps(counts)}, peak device memory {peak / 1e9:.3f} GB, "
          f"every gradient finite: {finite}")
    check(finite and math.isfinite(float(loss.detach())),
          "a bfloat16 gradient or the loss is not finite")
    check(counts["ssd_scan_bwd"] == cfg.n_layers
          and counts["ssd_scan"] == 2 * cfg.n_layers == rec.n,
          f"the bfloat16 backward launched {counts}")
    worst = 0.0
    layer_err = {}
    for i, call in sorted(rec.calls.items()):
        check("dy" in call, f"layer {i}'s SSD got no cotangent")
        args, dy = call["args"], call["dy"]
        check(args[0].dtype == dy.dtype == torch.bfloat16,
              f"layer {i}'s SSD ran in {args[0].dtype}, cotangent "
              f"{dy.dtype}")
        got = ss.ssd_scan_bwd_cuda(*args, dy, None)
        want = ref.ssd_chunked_bwd_ref(*args, dy, None, chunk=call["chunk"])
        errs = layer_err[i] = grads_err(got, want)
        worst = max([worst] + [e["err"] for e in errs.values()])
        print(f"  layer {i} bfloat16 SSD backward, kernel vs the plain "
              "version's bfloat16 gradients on its real inputs and "
              "cotangent: " + ", ".join(
                  f"{k} {e['err']:.3g} of {e['scale']:.4g}"
                  for k, e in errs.items())
              + f" (tol {SSD_BWD_TOL[torch.bfloat16]} of it)")
        check(all(e["ok"] for e in errs.values()),
              f"layer {i}: the bfloat16 backward differs: {errs}")
    return {"launches": counts, "peak_gb": peak / 1e9, "forward_s": fwd_s,
            "backward_s": bwd_s, "layer_err": layer_err,
            "max_abs_err": worst}


def ssd_bwd_times(sc, by_dtype: dict) -> dict:
    """The backward kernels and autograd of the plain chunked version timed
    at mamba2-1.3b's heads for each of ``ssd_bwd_timing.SHAPES`` (a training
    step's 8 x 256 tokens, and the serving prompts' 8 x 1024) in float32 and
    bfloat16 on that script's inputs, after an L2 evict, beside the bound; a
    cotangent of y alone, as training brings.  Each device kernel's time,
    registers, spills, shared memory and CTAs an SM beside them.  Their
    errors against the plain version are folded into ``by_dtype``
    (``fold_errs``), which is returned as ``max_err``."""
    h, g, p, n = sc.n_heads, sc.n_groups, sc.head_dim, sc.d_state
    check(ssd_bwd_timing.HEADS == dict(h=h, g=g, p=p, n=n),
          "ssd_bwd_timing times other heads than mamba2-1.3b's")
    rng = np.random.default_rng(6)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    (built,) = _build.build(ss.BWD_SOURCE)
    per_shape, usage, occ = [], {}, {}
    for dtype in ssd_bwd_timing.DTYPES:
        name = str(dtype)[6:]
        suffix = "IfEEv" if dtype == torch.float32 else "I13__nv_bfloat16EEv"
        usage[name] = {k: ptxas_usage(built.log, f"ssd_bwd_{k}_kernel"
                                      + suffix)
                       for k in ("states", "chunk", "reduce")}
        occ[name] = ss.bwd_occupancy(p, n, dtype)
        for b, s in ssd_bwd_timing.SHAPES:
            *args, dy = ssd_bwd_timing.inputs(rng, b, s, torch.device("cuda"),
                                              dtype)
            got = ss.ssd_scan_bwd_cuda(*args, dy, None)
            want = ref.ssd_chunked_bwd_ref(*args, dy, None, chunk=sc.chunk)
            errs = grads_err(got, want)
            check(all(e["ok"] for e in errs.values()),
                  f"ssd_scan_bwd {name} at ({b}, {s}) differs: {errs}")
            again = ss.ssd_scan_bwd_cuda(*args, dy, None)
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  "two backward calls gave different bits")
            fold_errs(by_dtype, dtype, errs)
            del got, want, again
            t = ssd_bwd_timing.time_shape(tuple(args), dy, flush)
            ms = t["ms"]
            plain_ms = event_ms(lambda: ref.ssd_chunked_bwd_ref(
                *args, dy, None, chunk=sc.chunk), flush)
            design = 2 * ss.bwd_fmas(b, s, h, p, n)
            print(f"  ssd_scan_bwd {name} (B,S,H,G,P,N)=({b},{s},{h},{g},{p},"
                  f"{n}): kernels {ms:.6f} ms, autograd of the plain chunked "
                  f"version (chunk {sc.chunk}) {plain_ms:.6f} ms, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}: {t['flops']} "
                  f"FLOP at the least chunk cost, L = {t['bound_chunk']}; "
                  f"{t['bytes']} bytes) = {100 * t['bound_ms'] / ms:.4f}% of "
                  f"the bound; design {design} FLOP of FMAs "
                  f"({design / t['flops']:.4f}x the bound's, "
                  f"{design / (ms * 1e-3) / 1e12:.3f} TFLOP/s); scratch "
                  f"{ss.bwd_scratch_bytes(b, s, h, g, p, n) / 1e6:.1f} MB; "
                  f"clusters of {ss.bwd_cluster(h, g)} heads; bit-identical "
                  "twice; max |err| "
                  + ", ".join(f"{k} {e['err']:.3g}" for k, e in errs.items()))
            for k, us in t["kernels_us"].items():
                key = k.split("_")[2]
                u = usage[name][key]
                extra = ""
                if key in ("states", "chunk"):
                    extra = (f", {occ[name][key + '_smem_bytes']} B of "
                             f"shared memory a CTA, "
                             f"{occ[name][key + '_ctas_per_sm']} CTA(s) an "
                             "SM (occupancy API)")
                print(f"    {k}: {us:.3f} us a call (torch.profiler, mean "
                      f"of 5; {100 * us / (ms * 1e3):.1f}% of the event "
                      f"time), {u['registers']} registers a thread, spills "
                      f"{u['spill_stores']} B stored / {u['spill_loads']} B "
                      f"loaded (ptxas){extra}")
            per_shape.append({"dtype": name, "shape": [b, s, h, g, p, n],
                              "plain_ms": plain_ms, "library_ms": None,
                              "design_flops": design,
                              "share": t["bound_ms"] / ms, **t})
            del args, dy
    print(f"    {ss.BWD_DEVICE_KERNELS} device kernels a call")
    return {"per_shape": per_shape, "ptxas": usage, "occupancy": occ,
            "max_err": by_dtype}


FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip", "router")


def leaf_dtypes(tree) -> dict:
    return {k: str(v.dtype)[6:] for k, v in tree_flatten(tree).items()}


def check_train_dtypes(params, opt, cfg, steps: int, label: str) -> None:
    """bfloat16 weights but the float32 ``a_log``, ``dt_bias``, ``d_skip``
    and router (``init_params(dtype=torch.bfloat16)``, the reference's
    leaf dtypes), moments at ``cfg.opt_dtype``, the step counter int32."""
    got = leaf_dtypes(params)
    want = {k: "float32" if k.split(SEP)[-1] in FLOAT32_LEAVES
            else "bfloat16" for k in got}
    check(got == want, f"{label}: weight dtypes {got}")
    for name in ("m", "v"):
        check(set(leaf_dtypes(opt[name]).values()) == {cfg.opt_dtype},
              f"{label}: {name} in {set(leaf_dtypes(opt[name]).values())}")
    check(opt["step"].dtype == torch.int32 and int(opt["step"]) == steps,
          f"{label}: step counter {opt['step']}")


def train_4k_cell(arch: str, reckoning=None) -> dict:
    """One arch's train_4k step (see ``phase_train_4k``); ``reckoning``, a
    future of its cell's ``cell_memory.reckon`` (``start_reckonings``), or
    None to reckon here."""
    free_device_memory()
    cell = SHAPES["train_4k"]
    cfg = get_arch(arch)
    rows, m = cell_memory.TRAIN_ROWS[arch], TRAIN_MICROBATCHES[arch]
    seq, steps = cell.seq_len, TRAIN_4K["steps"][arch]
    mamba = cfg.ssm is not None
    check(cfg.attn_impl_train == "chunked" and cfg.remat,
          f"{arch} does not train as the reference's config does")
    tokens = rows * seq
    flops = T.model_flops(cfg, tokens, seq)
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_4K["seed"])
    params = T.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype)
    opt = adamw_init(params, opt_cfg)
    check_train_dtypes(params, opt, cfg, 0, f"{arch} train_4k at init")
    batch = packed_batch(cfg, rows, seq)
    nonpad = int((batch["tokens"] != 0).sum())
    step = make_train_step(cfg, opt_cfg, num_microbatches=m)
    print(f"train_4k: {arch} ({cfg.n_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab}, remat, attention {cfg.attn_impl_train}), "
          f"{int(cfg.param_count())} bfloat16 parameters (random, seed "
          f"{TRAIN_4K['seed']}), moments {cfg.opt_dtype}; {rows} rows of the"
          f" cell's {cell.global_batch} x {seq} tokens "
          f"(launch/cell_memory.py:TRAIN_ROWS), {nonpad} of {tokens} "
          f"tokens not padding, {m} microbatches (TRAIN_MICROBATCHES); "
          f"{steps} steps on the one batch")
    # every SSD call's input dtypes, and layers 0 and last's inputs and
    # cotangents in microbatch 0 of step 0
    last = cfg.n_layers - 1
    rec = SsdGradRecorder((0, last))
    fwd_types, bwd_types = collections.Counter(), collections.Counter()
    bwd = ss.ssd_scan_bwd_cuda

    def fwd_spy(*args, **kw):
        fwd_types[tuple(str(a.dtype)[6:] for a in (args[0], args[3],
                                                   args[4]))] += 1
        return (rec if rec.n < 2 * cfg.n_layers else ss.ssd_scan_cuda)(
            *args, **kw)

    def bwd_spy(*args):
        bwd_types[tuple(str(args[i].dtype)[6:] for i in (0, 3, 4, 5))] += 1
        return bwd(*args)

    losses, gnorms, walls, peaks, counts = [], [], [], [], []
    micro_walls, update_walls = [], []
    M.ssd_scan_cuda, ss.ssd_scan_bwd_cuda = fwd_spy, bwd_spy
    try:
        with StepSplit() as split:
            for i in range(steps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                split.marks.clear()
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                check(len(split.marks) == m + 1, f"{arch}: step {i} entered "
                      f"loss_fn and the clip {len(split.marks)} times, "
                      f"expected {m + 1}")
                counts.append(launches())
                peaks.append(torch.cuda.max_memory_allocated())
                walls.append(t1 - t0)
                micro_walls.append([b - a for a, b in zip(split.marks,
                                                          split.marks[1:])])
                update_walls.append(t1 - split.marks[-1])
                losses.append(float(metrics["loss"]))
                gnorms.append(float(metrics["grad_norm"]))
                wall = walls[-1]
                print(f"    step {i}: loss {losses[-1]:.6f}, grad norm "
                      f"{gnorms[-1]:.6f}, wall {wall:.6f} s = "
                      f"{split.marks[0] - t0:.6f} s before microbatch 0 + "
                      f"{m} microbatches (forward, backward, float32 sum) "
                      + " + ".join(f"{t:.6f}" for t in micro_walls[-1])
                      + f" s + update (clip, AdamW) {update_walls[-1]:.6f}"
                      f" s; {tokens / wall:.1f} tokens/s, "
                      f"{flops / wall / 1e12:.3f} model TFLOP/s "
                      f"({flops * 4 / 3 / wall / 1e12:.3f} with remat), "
                      f"peak {peaks[-1] / 1e9:.3f} GB, launches "
                      f"{json.dumps(counts[-1])}")
    finally:
        M.ssd_scan_cuda, ss.ssd_scan_bwd_cuda = ss.ssd_scan_cuda, bwd
    check(all(map(math.isfinite, losses + gnorms)),
          f"{arch}: losses {losses}, grad norms {gnorms}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses}")
    check_train_dtypes(params, opt, cfg, steps, f"{arch} train_4k")
    micro_s = statistics.median(t for w in micro_walls[1:] for t in w)
    update_s = statistics.median(update_walls[1:])
    mb = {k: v[:rows // m] for k, v in batch.items()}

    def microbatch():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = T.loss_fn(leaves, cfg, mb)
        return torch.autograd.grad(loss, tree_leaves(leaves))
    _, busy_s = step_profile(microbatch, micro_s, f"{arch} train_4k: one "
                             f"microbatch ({rows // m} x {seq} tokens) "
                             "forward and backward, traced against the "
                             "median untraced microbatch of steps 1-")
    del params, opt, _
    want = dict.fromkeys(counts[0], 0)
    if mamba:
        want.update(ssd_scan=2 * cfg.n_layers * m,
                    ssd_scan_bwd=cfg.n_layers * m)
    check(all(c == want for c in counts), f"{arch}: launches a step "
          f"{counts}, expected {want}" + ("" if mamba else ": attention "
                                          "trains through chunked"))
    check(set(fwd_types) <= {("bfloat16",) * 3}
          and set(bwd_types) <= {("bfloat16",) * 4}
          and sum(fwd_types.values()) == steps * want["ssd_scan"]
          and sum(bwd_types.values()) == steps * want["ssd_scan_bwd"],
          f"{arch}: SSD calls by input dtypes {dict(fwd_types)}, backward "
          f"{dict(bwd_types)}")
    timed = sorted(walls[1:])
    wall = timed[len(timed) // 2]
    out = {"rows": rows, "microbatches": m, "tokens": tokens,
           "nonpad": nonpad, "losses": losses, "grad_norms": gnorms,
           "walls": walls, "wall_s": wall, "tokens_per_s": tokens / wall,
           "model_tflops": flops / wall / 1e12, "peaks": peaks,
           "microbatch_walls": micro_walls, "update_walls": update_walls,
           "microbatch_s": micro_s, "update_s": update_s,
           "microbatch_busy_s": busy_s,
           "launches_per_step": counts[0],
           "launches": {k: sum(c[k] for c in counts) for k in counts[0]}}
    print(f"  {arch} train_4k: median step wall (steps 1-{steps - 1}) "
          f"{wall:.6f} s, {tokens / wall:.1f} tokens/s, "
          f"{flops / wall / 1e12:.3f} model TFLOP/s; median microbatch "
          f"{micro_s:.6f} s (x {m} = {m * micro_s:.6f} s), median update "
          f"{update_s:.6f} s; peaks "
          + ", ".join(f"{p / 1e9:.3f}" for p in peaks) + " GB; SSD calls by "
          f"input dtypes {dict(fwd_types)}, backward {dict(bwd_types)}")
    if mamba:
        out.update(train_4k_ssd_checks(cfg, rec))
    scratch = ss.bwd_scratch_bytes(rows // m, seq, cfg.ssm.n_heads,
                                   cfg.ssm.n_groups, cfg.ssm.head_dim,
                                   cfg.ssm.d_state) if mamba else 0
    got = out["reckoned"] = reckoning.result() if reckoning is not None \
        else cell_memory.reckon(cfg, cell, rows)
    peak = max(peaks[1:])
    low = got["total"] - TRAIN_4K_PEAK_MARGIN
    high = got["total"] + TRAIN_4K_PEAK_MARGIN + scratch
    print(f"  {arch} train_4k peak {peak / 1e9:.3f} GB (steps 1-; step 0, "
          f"SSD inputs recorded: {peaks[0] / 1e9:.3f}), reckoned "
          f"{got['total'] / 1e9:.3f} GB (weights {got['params'] / 1e9:.3f}, "
          f"optimizer state {got['opt'] / 1e9:.3f}, made "
          f"{got['peak'] / 1e9:.3f}); within [{low / 1e9:.3f}, "
          f"{high / 1e9:.3f}]: {low <= peak <= high}")
    check(max(peaks) < 80e9,
          f"{arch}: a step needed {max(peaks) / 1e9:.3f} GB")
    check(low <= peak <= high, f"{arch}: peak {peak} B against the "
          f"reckoned {got['total']} B")
    return out


class StepSplit:
    """Marks where each microbatch of a train step begins (``T.loss_fn``
    entered) and where its update begins (``clip_by_global_norm``
    entered), each after a device synchronise, in ``marks``: a step of m
    microbatches leaves m + 1 marks."""

    def __enter__(self):
        self.marks: list = []
        self.saved = T.loss_fn, train_loop.clip_by_global_norm

        def mark(fn):
            def spy(*args, **kw):
                torch.cuda.synchronize()
                self.marks.append(time.perf_counter())
                return fn(*args, **kw)
            return spy
        T.loss_fn, train_loop.clip_by_global_norm = map(mark, self.saved)
        return self

    def __exit__(self, *exc):
        T.loss_fn, train_loop.clip_by_global_norm = self.saved


def train_4k_ssd_checks(cfg, rec: SsdGradRecorder) -> dict:
    """Layers 0 and last's SSD backward in microbatch 0 of step 0, on the
    step's real inputs and cotangents, against autograd of the plain
    chunked version in bfloat16; then the backward kernels timed on layer
    0's inputs beside the bound and the plain version."""
    layer_err, shape = {}, None
    for i, call in sorted(rec.calls.items()):
        check("dy" in call, f"layer {i}'s SSD got no cotangent")
        args, dy = call["args"], call["dy"]
        x, bm = args[0], args[3]
        shape = [*x.shape[:3], bm.shape[2], x.shape[3], bm.shape[3]]
        got = ss.ssd_scan_bwd_cuda(*args, dy, None)
        want = ref.ssd_chunked_bwd_ref(*args, dy, None, chunk=call["chunk"])
        errs = layer_err[i] = grads_err(got, want)
        del got, want
        print(f"  layer {i} bfloat16 SSD backward at (B,S,H,G,P,N)="
              f"{tuple(shape)}, kernel vs the plain version's bfloat16 "
              "gradients on its real inputs and cotangent: " + ", ".join(
                  f"{k} {e['err']:.3g} of {e['scale']:.4g}"
                  for k, e in errs.items())
              + f" (tol {SSD_BWD_TOL[torch.bfloat16]} of it)")
        check(all(e["ok"] for e in errs.values()),
              f"layer {i}: the bfloat16 backward differs: {errs}")
    call = rec.calls[0]
    args, dy = tuple(call["args"]), call["dy"]
    del rec
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t = ssd_bwd_timing.time_shape(args, dy, flush)
    plain_ms = event_ms(lambda: ref.ssd_chunked_bwd_ref(
        *args, dy, None, chunk=call["chunk"]), flush)
    print(f"  ssd_scan_bwd bfloat16 at the train_4k microbatch's "
          f"(B,S,H,G,P,N)={tuple(shape)} on layer 0's inputs: kernels "
          f"{t['ms']:.6f} ms, autograd of the plain chunked version "
          f"{plain_ms:.6f} ms, bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']}: {t['flops']} FLOP, {t['bytes']} bytes) = "
          f"{100 * t['bound_ms'] / t['ms']:.4f}% of the bound; "
          + ", ".join(f"{k} {us:.3f} us" for k, us in
                      t["kernels_us"].items()))
    return {"layer_err": layer_err,
            "times": {"path": f"{cfg.name} train_4k bfloat16",
                      "dtype": "bfloat16", "shape": shape,
                      "plain_ms": plain_ms, "library_ms": None, **t}}


def phase_train_4k(reckonings: dict | None = None) -> dict:
    """The reference's train_4k cell in bfloat16 (``launch/dryrun.py:
    _lower_cell``'s train branch, which the dry run runs on meta): olmo-1b
    and mamba2-1.3b at full width, bfloat16 weights from a seed, moments
    at ``opt_dtype``, ``TRAIN_ROWS`` rows of 4,096 tokens,
    ``make_train_step`` with the arch's ``TRAIN_MICROBATCHES``, four steps
    (mamba2-1.3b three, ``TRAIN_4K``) on one repeated batch: losses finite
    and falling, leaf dtypes kept,
    olmo-1b launching no kernel wrapper (attention trains through
    ``chunked``), mamba2-1.3b 96 m ``ssd_scan`` and 48 m ``ssd_scan_bwd``
    launches a step, all on bfloat16 inputs, and layers 0 and 47's
    backward against the plain version; step walls split into the
    microbatches and the update, tokens/s, model TFLOP/s, one microbatch
    traced, and each step's peak beside ``cell_memory.reckon``'s (futures
    by arch in ``reckonings``, from ``start_reckonings``, or reckoned
    here)."""
    return {arch: train_4k_cell(arch, (reckonings or {}).get(arch))
            for arch in cell_memory.TRAIN_ROWS}


def training_report(trainer, res, cfg, tokens, flops, n_params, run_s
                    ) -> None:
    """Print the run's numbers and check what it must hold."""
    hist = res["history"]
    p = sum(t.numel() for t in tree_leaves(res["params"]))
    cal = trainer.calibration
    run_log = trainer.step_log[len(cal["steps"]):]
    peaks = {"step": max(r["peak"] for r in trainer.step_log),
             "restore": max(r["peak"] for r in trainer.ckpt.restores)}
    print(f"  parameters P = {p}; Trainer.run wall {run_s:.3f} s; peak "
          f"device memory {max(peaks.values()) / 1e9:.3f} GB (in a step "
          f"{peaks['step'] / 1e9:.3f} GB, in the restore "
          f"{peaks['restore'] / 1e9:.3f} GB)")
    check(p == n_params, f"{p} parameters, param_count() says {n_params}")
    cm = trainer.controller.cost_model
    print(f"  calibration: {len(cal['steps'])} steps of "
          f"{', '.join(format(r['wall_s'], '.6f') for r in cal['steps'])} s "
          f"(the first with warm-up, as in the reference); CostModel "
          f"seconds = "
          + " + ".join(f"{w:.6g}*{n}" for w, n in zip(cm.weights,
                                                       cm.feature_names))
          + f"; weights equal to the initial ones after it: "
          f"{cal['unchanged']}")
    check(cal["unchanged"], "calibration changed the weights")
    freqs = [b.rel_freq for b in trainer.controller.plan.blocks]
    busy, dvo = res["energy"]["busy_j"], res["energy_dvo"]["busy_j"]
    print(f"  DV-DVFS plan over {len(freqs)} blocks (paper planner, "
          f"deadline {trainer.tc.deadline_slack}x the estimate at f_max): "
          f"frequencies {freqs}; energy vs DVO, simulated with the copied "
          f"TPU_V5E_POWER curve (not the card's energy): "
          f"{100 * (1 - busy / dvo):+.4f}%")
    print(f"  steps ({tokens} tokens each; model FLOP "
          f"{flops:.6g} = 6ND-style, with remat's extra forward "
          f"{flops * 4 / 3:.6g}):")
    for h, r in zip(hist, run_log):
        print(f"    step {h['step']}: loss {h['loss']:.6f}, wall "
              f"{h['wall_s']:.6f} s, {tokens / h['wall_s']:.1f} tokens/s, "
              f"{flops / h['wall_s'] / 1e12:.3f} model TFLOP/s "
              f"({flops * 4 / 3 / h['wall_s'] / 1e12:.3f} with remat), "
              f"peak {r['peak'] / 1e9:.3f} GB, rel_freq {h['rel_freq']}")
    for s in trainer.ckpt.saves:
        print(f"  save at step {s['step']}: {s['bytes']} bytes; snapshot to "
              f"the host {s['snapshot_s']:.3f} s, written "
              f"{s['total_s'] - s['snapshot_s']:.3f} s later on the "
              f"manager's thread ({s['bytes'] / s['total_s'] / 1e9:.3f} GB/s "
              f"from save() to the renamed checkpoint)")
    for r in trainer.ckpt.restores:
        print(f"  restore of step {r['step']}: waited {r['wait_s']:.3f} s "
              f"for the write in flight, loaded onto the card in "
              f"{r['load_s']:.3f} s")
    steps = [h["step"] for h in hist]
    fail = TRAIN["fail_at"]
    back = fail - fail % TRAIN["ckpt_every"]
    check(steps == list(range(fail)) + list(range(back, TRAIN["total_steps"])),
          f"steps ran as {steps}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    again = {s: [h["loss"] for h in hist if h["step"] == s]
             for s in range(back, fail)}
    print(f"  losses of the steps run before and after the restore: "
          f"{again}")
    check(all(a == b for a, b in again.values()),
          "the repeated steps' losses are not bit-identical")
    check(len(trainer.ckpt.restores) == 1
          and trainer.ckpt.restores[0]["step"] == back,
          f"restores {trainer.ckpt.restores}")


def phase_training_smoke() -> None:
    """At smoke size on the card: 25 steps whose loss decreases, and the
    reference's clean-against-faulty run, bit for bit; then a backward
    through the flash kernel must raise, and smoke mamba2 and jamba train
    on the card as on the CPU."""
    cfg = smoke_config("olmo-1b")
    ds = BlockDataset(n_blocks=4, records_per_block=64, max_len=48,
                      vocab=cfg.vocab, seed=1)

    def run(tmp, name, **kw):
        fail = kw.pop("inject_failure_at", None)
        tc = TrainConfig(**{**TRAIN_SMOKE, **kw,
                            "ckpt_dir": os.path.join(tmp, name)})
        return Trainer(cfg, tc, dataset=ds, device="cuda").run(
            resume=False, inject_failure_at=fail)

    with tempfile.TemporaryDirectory() as tmp, deterministic():
        long = run(tmp, "long", total_steps=25)
        clean = run(tmp, "clean")
        faulty = run(tmp, "faulty", inject_failure_at=SMOKE_FAIL_AT)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(clean["params"]), tree_leaves(faulty["params"])))
    print(f"training at smoke size ({cfg.name}, {cfg.n_layers} layer, "
          f"d_model {cfg.d_model}): 25 steps, loss "
          f"{long['first_loss']:.6f} -> {long['final_loss']:.6f}; a failure "
          f"at step {SMOKE_FAIL_AT} restored from step 8 gives the clean "
          f"run's parameters bit for bit: {same}")
    check(np.isfinite(long["final_loss"])
          and long["final_loss"] < long["first_loss"],
          "the smoke run's loss did not decrease")
    check(same, "the faulty run's parameters differ from the clean run's")
    c = smoke_config("olmo-1b", attn_impl_train="pallas")
    params = tree_map(lambda t: t.requires_grad_(), T.init_params(
        c, torch.Generator(device="cuda").manual_seed(0), device="cuda"))
    toks = torch.ones((2, 32), dtype=torch.int32, device="cuda")
    try:
        loss, _ = T.loss_fn(params, c, {"tokens": toks, "labels": toks})
        loss.backward()
    except NotImplementedError as e:
        print(f"  backward through olmo-1b (pallas) on the card raises: {e}")
    else:
        raise RuntimeError("chip_smoke: a backward through the flash kernel "
                           "ran without a backward kernel")
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b"):
        smoke_train_card_vs_cpu(arch)


def smoke_train_card_vs_cpu(arch: str) -> None:
    """``arch`` at smoke size (remat on) on the card and on the CPU from the
    same weights: the first batch's gradients within SMOKE_GRAD_TOL of each
    leaf's largest CPU magnitude; two train steps' losses and gradient
    norms within SMOKE_TRAIN_TOL relative and their weights within
    SMOKE_WEIGHT_TOL; on the card each Mamba layer runs the SSD kernel
    twice a step (the forward and remat's recomputation) and its backward
    once, the CPU launches nothing."""
    cfg = smoke_config(arch, remat=True)
    n_mamba = [s.mixer for s in cfg.pattern].count("mamba") * cfg.n_repeats
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    batches = [{k: rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        leaves = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = T.loss_fn(leaves, cfg, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batches[0].items()})
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        reset_launches()
        state = adamw_init(p, opt)
        metrics = []
        for b in batches:
            p, state, m = step(p, state, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()})
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
        out[dev] = (metrics, p, launches(), grads)
    want = dict.fromkeys(launches(), 0)
    want.update(ssd_scan=4 * n_mamba, ssd_scan_bwd=2 * n_mamba)
    check(out["cuda"][2] == want and not any(out["cpu"][2].values()),
          f"smoke {arch} train steps launched {out['cuda'][2]} on the card "
          f"(expected {want}) and {out['cpu'][2]} on the CPU")
    gerr = max(_max_err(a.cpu(), b) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(out["cuda"][3], out["cpu"][3]))
    rel = max(abs(a - b) / abs(b) for ra, rb in zip(out["cuda"][0],
                                                    out["cpu"][0])
              for a, b in zip(ra, rb))
    perr = max(_max_err(a.cpu(), b) for a, b in zip(
        tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])))
    print(f"  smoke {arch} ({n_mamba} Mamba layer(s), remat) trains on the "
          f"card: gradients max |err| {gerr:.3g} of each leaf's largest "
          f"(tol {SMOKE_GRAD_TOL}); 2 steps, losses and grad norms card "
          f"{out['cuda'][0]} cpu {out['cpu'][0]} (max rel {rel:.3g}, tol "
          f"{SMOKE_TRAIN_TOL}), weights max |err| {perr:.3g} (tol "
          f"{SMOKE_WEIGHT_TOL}); card launches {json.dumps(out['cuda'][2])}")
    check(gerr <= SMOKE_GRAD_TOL and rel <= SMOKE_TRAIN_TOL
          and perr <= SMOKE_WEIGHT_TOL,
          f"smoke {arch}: the card's train steps differ from the CPU's")


# ------------------------------------------------------- the sharded path --

PARALLEL_MESH = {"data": 1, "model": 1}
PARALLEL_DECODE_STEPS = 16
PARALLEL_TRAIN = dict(batch=8, seq_len=256, steps=2, lr=3e-4)
PARALLEL_LOGIT_TOL = 1e-5      # float32, world size 1: the same kernels
MOE_PARALLEL_TOL = 1e-6        # tests/test_layouts.py's bound


@contextlib.contextmanager
def nccl_world_of_one():
    """A one-rank NCCL process group of this process, its store a file under
    TMPDIR (no port is opened); destroyed on exit."""
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir)


def sharded(tree, specs, mesh):
    """``tree`` as DTensors laid out by ``specs``; at world size 1 each
    wraps its tensor's storage (checked: no copy)."""
    out = distribute_tree(tree, specs, mesh)
    wrapped = tree_flatten(out)
    for k, t in tree_flatten(tree).items():
        if isinstance(t, torch.Tensor):
            check(wrapped[k].to_local().data_ptr() == t.data_ptr(),
                  f"distribute_tree copied {k}")
    return out


def parallel_collectives(mesh_pd) -> dict:
    """int8_all_reduce and hierarchical_grad_reduce under NCCL."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 3.0, (1000,)).astype(np.float32)
                         ).cuda()
    out = int8_all_reduce(x, mesh_pd.get_group("pod"))
    err = _max_err(out, x)
    bound = float(x.abs().max()) / 127.0 + 1e-6
    print(f"  int8_all_reduce over 'pod' (NCCL, 1 rank), 1000 normal(0, 3) "
          f"float32: max |err| {err:.6g} (bound max|x|/127 + 1e-6 = "
          f"{bound:.6g})")
    check(err <= bound, f"int8_all_reduce off by {err}")
    table = torch.from_numpy(rng.normal(0, 0.02, (50304, 2048)).astype(
        np.float32)).cuda()
    int8_all_reduce(table, mesh_pd.get_group("pod"))          # warm-up
    walls = []
    for _ in range(5):
        got, s = sync_seconds(lambda: int8_all_reduce(
            table, mesh_pd.get_group("pod")))
        walls.append(s)
    terr = _max_err(got, table)
    tbound = float(table.abs().max()) / 127.0 + 1e-6
    print(f"  int8_all_reduce of olmo-1b's embedding table (50304 x 2048 "
          f"float32, {table.numel() * 4 / 1e6:.1f} MB): walls "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; max |err| "
          f"{terr:.6g} (bound {tbound:.6g})")
    check(terr <= tbound, f"int8_all_reduce of the table off by {terr}")
    del table, got
    hier = {}
    for compress in (True, False):
        h = hierarchical_grad_reduce({"w": x}, mesh_pd,
                                     compress_cross_pod=compress)["w"]
        hier["int8" if compress else "float"] = _max_err(h, x)
    print(f"  hierarchical_grad_reduce on (pod 1, data 1): int8 max |err| "
          f"{hier['int8']:.6g} (bound {bound:.6g}), float {hier['float']}")
    check(hier["int8"] <= bound and hier["float"] == 0.0,
          f"hierarchical_grad_reduce: {hier}")
    return {"int8_err": err, "table_ms": float(np.median(walls)) * 1e3,
            "table_err": terr, "hier": hier}


def greedy_decode(params, cfg, first, cache, steps: int, lay=None):
    """``steps`` greedy ``decode_step``s from the tokens ``first`` (B, 1);
    returns (tokens (B, steps), per-step seconds).  ``lay`` lays each step's
    tokens out for a sharded run."""
    toks, walls = [], []
    tok = first
    for _ in range(steps):
        (logits, cache), s = sync_seconds(lambda: T.decode_step(
            params, cfg, tok if lay is None else lay(tok), cache))
        walls.append(s)
        logits = logits.full_tensor() if hasattr(logits, "full_tensor") \
            else logits
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1), walls


def parallel_olmo_serving(mesh) -> dict:
    """olmo-1b at full width, weights laid out by ``param_specs``: the
    serving traffic's prefill and 16 greedy decode steps, plain then
    sharded, on the same weights."""
    dev = torch.device("cuda")
    msd = mesh_shape_dict(mesh)
    sv = SERVE
    cfg = build_cfg(sv["arch"], msd, kind="decode").replace(
        attn_impl_train="pallas")
    check(cfg.batch_axes == ("data",), f"batch_axes {cfg.batch_axes}")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        sv["seed"]), device=dev)
    prompts = torch.from_numpy(np.random.default_rng(sv["seed"]).integers(
        1, cfg.vocab, (sv["batch"], sv["prompt"])).astype(np.int32)).to(dev)
    lay = lambda t: distribute_tree(t, P("data"), mesh)
    plain = lambda: T.prefill(params, cfg, {"tokens": prompts},
                              sv["max_len"])
    torch.cuda.reset_peak_memory_stats()
    sync_seconds(plain)                                        # warm-up
    (want, wcache), plain_s = sync_seconds(plain)
    first = want.argmax(-1).to(torch.int32)[:, None]
    plain_toks, plain_walls = greedy_decode(params, cfg, first, wcache,
                                            PARALLEL_DECODE_STEPS)
    del wcache
    dparams = sharded(params, param_specs(cfg, params, msd), mesh)
    batch = {"tokens": prompts}
    dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
    shard = lambda: T.prefill(dparams, cfg, dbatch, sv["max_len"])
    reset_launches()
    (got, gcache), shard_s = sync_seconds(shard)
    counts = launches()
    got = got.full_tensor()
    err = _max_err(got, want)
    same = torch.equal(got, want)
    k0 = gcache["blocks"][0]["k"]
    print(f"  olmo-1b sharded prefill ({sv['batch']} x {sv['prompt']} "
          f"tokens, mesh {msd}, batch_axes {cfg.batch_axes}): launches "
          f"{json.dumps(counts)}; last logits vs plain max |err| {err:.6g} "
          f"(tol {PARALLEL_LOGIT_TOL}), bit-identical {same}; cache "
          f"{type(k0).__name__} {tuple(k0.shape)} {k0.placements}")
    check(counts["flash_attention"] == cfg.n_layers
          and sum(counts.values()) == cfg.n_layers,
          f"the sharded prefill launched {counts}, not flash once a layer")
    check(err <= PARALLEL_LOGIT_TOL, f"sharded prefill logits off by {err}")
    shard_toks, shard_walls = greedy_decode(dparams, cfg, first, gcache,
                                            PARALLEL_DECODE_STEPS, lay)
    check(torch.equal(shard_toks, plain_toks),
          "sharded greedy tokens differ from plain")
    del gcache
    # in turns: plain, sharded, sharded, plain
    shard2_s = sync_seconds(shard)[1]
    plain2_s = sync_seconds(plain)[1]
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = lambda w: float(np.median(w[1:])) * 1e3
    print(f"  prefill walls in turns (after a warm-up): plain "
          f"{plain_s:.6f}, sharded {shard_s:.6f}, sharded {shard2_s:.6f}, "
          f"plain {plain2_s:.6f} s; decode a step (median of steps "
          f"2-{PARALLEL_DECODE_STEPS}): plain {ms(plain_walls):.3f} ms, "
          f"sharded {ms(shard_walls):.3f} ms; greedy tokens equal over "
          f"{PARALLEL_DECODE_STEPS} steps; peak {peak:.3f} GB")
    return {"launches": counts, "logit_err": err, "bit_identical": same,
            "prefill_s": {"plain": [plain_s, plain2_s],
                          "sharded": [shard_s, shard2_s]},
            "decode_ms": {"plain": ms(plain_walls),
                          "sharded": ms(shard_walls)}, "peak_gb": peak}


def parallel_olmo_training(mesh) -> dict:
    """Two train steps of olmo-1b at full width, plain and sharded (batch
    over 'data', ZeRO-1 moments, gradients over 'data'), from the same
    weights, under deterministic algorithms."""
    dev = torch.device("cuda")
    msd = mesh_shape_dict(mesh)
    tr = PARALLEL_TRAIN
    cfg = build_cfg("olmo-1b", msd, kind="train").replace(
        grad_shard=("data", msd["data"]))
    check(cfg.attn_impl_train == "chunked" and cfg.remat,
          "training runs chunked attention under remat")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt_cfg = AdamWConfig(lr=tr["lr"])
    opt = adamw_init(params, opt_cfg)
    batch = packed_batch(cfg, tr["batch"], tr["seq_len"])
    step = make_train_step(cfg, opt_cfg)

    def run(p, o, b):
        losses, walls = [], []
        for _ in range(tr["steps"]):
            (p, o, m), s = sync_seconds(lambda: step(p, o, b))
            losses.append(m["loss"])
            walls.append(s)
        return p, o, losses, walls

    torch.cuda.reset_peak_memory_stats()
    with deterministic():
        want_p, want_o, want_l, plain_walls = run(params, opt, batch)
        del want_o
        specs = param_specs(cfg, params, msd)
        zs = zero1_specs(specs, params, msd)
        dparams = sharded(params, specs, mesh)
        dopt = sharded(opt, {"m": zs, "v": zs, "step": P()}, mesh)
        dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
        got_p, got_o, got_l, shard_walls = run(dparams, dopt, dbatch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    got_l = [float(l.full_tensor()) for l in got_l]
    want_l = [float(l) for l in want_l]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got_l, want_l))
    perr, pmax = 0.0, 0.0
    for k, w in tree_flatten(want_p).items():
        g = tree_flatten(got_p)[k]
        perr = max(perr, _max_err(g.full_tensor(), w))
        pmax = max(pmax, float(w.abs().max()))
    kept = all(a.placements == b.placements for a, b in zip(
        tree_flatten(got_o["m"]).values(), tree_flatten(dopt["m"]).values()))
    print(f"  olmo-1b sharded train steps ({tr['batch']} x {tr['seq_len']} "
          f"tokens, grad_shard {cfg.grad_shard}, ZeRO-1 moments, chunked "
          f"attention, remat, deterministic): losses plain "
          f"{want_l} sharded {got_l} (max rel {rel:.3g}); new weights max "
          f"|err| {perr:.6g} (|w| up to {pmax:.4g}; tol 1e-5 relative); "
          f"moments kept their layout {kept}; step walls plain "
          f"{', '.join(f'{w:.6f}' for w in plain_walls)} s, sharded "
          f"{', '.join(f'{w:.6f}' for w in shard_walls)} s; peak "
          f"{peak:.3f} GB")
    check(rel <= 1e-5 and perr <= 1e-5 * max(pmax, 1.0),
          f"the sharded step differs: loss rel {rel}, weights {perr}")
    check(kept, "ZeRO-1 moments lost their layout")
    return {"loss_rel": rel, "param_err": perr,
            "step_s": {"plain": plain_walls, "sharded": shard_walls},
            "peak_gb": peak}


def parallel_moe(mesh) -> dict:
    """qwen2-moe-a2.7b at full width, groups and experts over 'data': the
    plain prefill, then the same weight storage wrapped as DTensors
    (``from_local``, no copy) and the sharded prefill."""
    dev = torch.device("cuda")
    msd = mesh_shape_dict(mesh)
    sv = MOE_SERVE
    base = build_cfg(sv["arch"], msd, kind="decode")
    cfg = base.replace(attn_impl_train="pallas", moe=dataclasses.replace(
        base.moe, group_axis="data", expert_axis="data"))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        sv["seed"]), device=dev)
    prompts = torch.from_numpy(np.random.default_rng(sv["seed"]).integers(
        1, cfg.vocab, (sv["batch"], sv["prompt"])).astype(np.int32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    plain_routes = RouteRecorder()
    (want, cache), plain_s = sync_seconds(lambda: recorded_prefill(
        params, cfg, prompts, sv["max_len"], route=plain_routes))
    del cache
    dparams = sharded(params, param_specs(cfg, params, msd), mesh)
    wi = dparams["blocks"][0]["moe"]["wi"]
    batch = {"tokens": prompts}
    dbatch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)
    shard_routes = RouteRecorder()
    reset_launches()
    (got, cache), shard_s = sync_seconds(lambda: recorded_prefill(
        dparams, cfg, dbatch["tokens"], sv["max_len"], route=shard_routes))
    counts = launches()
    del cache
    got = got.full_tensor()
    # in turns: plain, sharded, sharded, plain
    shard2_s = sync_seconds(lambda: T.prefill(
        dparams, cfg, dbatch, sv["max_len"]))[1]
    plain2_s = sync_seconds(lambda: T.prefill(
        params, cfg, {"tokens": prompts}, sv["max_len"]))[1]
    err = _max_err(got, want)
    flips = sum(int((a[0] != b[0]).sum()) + int((a[1] != b[1]).sum())
                for a, b in zip(plain_routes.routes, shard_routes.routes))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  qwen2-moe-a2.7b sharded prefill (groups and experts over "
          f"'data', expert weights {tuple(wi.shape)} {wi.placements}): "
          f"launches {json.dumps(counts)}; last logits vs plain max |err| "
          f"{err:.6g} (tol {MOE_PARALLEL_TOL}), bit-identical "
          f"{torch.equal(got, want)}; {len(shard_routes.routes)} MoE calls, "
          f"{flips} routes or keep flags differ; prefill walls in turns: "
          f"plain {plain_s:.6f}, sharded {shard_s:.6f}, sharded "
          f"{shard2_s:.6f}, plain {plain2_s:.6f} s; peak {peak:.3f} GB")
    check(counts["flash_attention"] == cfg.n_layers
          and sum(counts.values()) == cfg.n_layers,
          f"the sharded prefill launched {counts}, not flash once a layer")
    check(len(shard_routes.routes) == cfg.n_layers and flips == 0,
          f"the sharded prefill routed differently ({flips} flips)")
    check(err <= MOE_PARALLEL_TOL, f"sharded MoE logits off by {err}")
    check(peak < 80, f"the sharded MoE prefill needed {peak} GB")
    return {"launches": counts, "logit_err": err, "route_flips": flips,
            "prefill_s": {"plain": [plain_s, plain2_s],
                          "sharded": [shard_s, shard2_s]},
            "peak_gb": peak}


def parallel_smoke(mesh, arch: str, kernels: set) -> dict:
    """``arch`` at smoke size, plain then sharded on the card: each kernel
    once a layer whose mixer runs it, and the same logits."""
    dev = torch.device("cuda")
    msd = mesh_shape_dict(mesh)
    cfg = smoke_config(arch, attn_impl_train="pallas", batch_axes=("data",))
    mixers = [spec.mixer for spec in cfg.pattern] * cfg.n_repeats
    want_counts = {name: sum(MIXER_KERNEL[m] == name for m in mixers)
                   if name in kernels else 0 for name in launches()}
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (2, 48)).astype(np.int32)).to(dev)
    want, _ = T.prefill(params, cfg, {"tokens": prompts}, 96)
    dparams = sharded(params, param_specs(cfg, params, msd), mesh)
    batch = {"tokens": prompts}
    reset_launches()
    got, _ = T.prefill(dparams, cfg, distribute_tree(
        batch, batch_specs(cfg, batch, msd), mesh), 96)
    counts = launches()
    err = _max_err(got.full_tensor(), want)
    print(f"  {arch} at smoke size, sharded prefill: launches "
          f"{json.dumps(counts)} (expected {json.dumps(want_counts)}); "
          f"logits vs plain on the card max |err| {err:.3g} (tol "
          f"{PARALLEL_LOGIT_TOL})")
    check(counts == want_counts, f"sharded smoke {arch} launched {counts}")
    check(err <= PARALLEL_LOGIT_TOL, f"sharded smoke {arch} off by {err}")
    return {"launches": counts, "logit_err": err}


def whole(t):
    """A DTensor's whole value; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def parallel_mamba_training(mesh) -> dict:
    """One train step of smoke mamba2-1.3b (remat), plain then sharded on
    the card from the same weights, the SSD's backward on the rank's heads
    under ``local_map``: losses, gradient norms and weights within 1e-5
    relative."""
    dev = torch.device("cuda")
    msd = mesh_shape_dict(mesh)
    cfg = smoke_config("mamba2-1.3b", remat=True, batch_axes=("data",))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 48)).astype(
        np.int32)).to(dev) for k in ("tokens", "labels")}
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt_cfg)
    want_p, _, want_m = step(params, adamw_init(params, opt_cfg), batch)
    specs = param_specs(cfg, params, msd)
    dopt = sharded(adamw_init(params, opt_cfg),
                   {"m": specs, "v": specs, "step": P()}, mesh)
    reset_launches()
    got_p, _, got_m = step(sharded(params, specs, mesh), dopt,
                           distribute_tree(batch, batch_specs(cfg, batch, msd),
                                           mesh))
    counts = launches()
    rel = max(abs(float(whole(got_m[k])) - float(want_m[k]))
              / abs(float(want_m[k])) for k in ("loss", "grad_norm"))
    perr, pmax = 0.0, 0.0
    for k, w in tree_flatten(want_p).items():
        perr = max(perr, _max_err(whole(tree_flatten(got_p)[k]), w))
        pmax = max(pmax, float(w.abs().max()))
    print(f"  mamba2-1.3b at smoke size, one sharded train step (remat): "
          f"launches {json.dumps(counts)}; loss and grad norm max rel "
          f"{rel:.3g}, new weights max |err| {perr:.3g} (|w| up to "
          f"{pmax:.4g}; tol 1e-5 relative)")
    check(counts["ssd_scan"] == 2 * cfg.n_layers
          and counts["ssd_scan_bwd"] == cfg.n_layers,
          f"the sharded step launched {counts}")
    check(rel <= 1e-5 and perr <= 1e-5 * max(pmax, 1.0),
          f"the sharded Mamba step differs: rel {rel}, weights {perr}")
    return {"launches": counts, "rel": rel, "param_err": perr}


def phase_parallel(smi: str) -> dict:
    """The sharded path (DTensors on a DeviceMesh) at world size 1 under
    NCCL: collectives, olmo-1b serving and training and qwen2-moe-a2.7b's
    prefill at full width, mamba2-1.3b and jamba at smoke size (and a
    mamba2-1.3b train step), each against the plain path on the same
    weights."""
    free_device_memory()
    print(f"sharded path on {smi} (NCCL, world size 1):")
    out = {}
    with nccl_world_of_one():
        mesh = make_mesh(PARALLEL_MESH, "cuda")
        out["collectives"] = parallel_collectives(
            make_mesh({"pod": 1, "data": 1}, "cuda"))
        out["olmo"] = parallel_olmo_serving(mesh)
        free_device_memory()
        out["olmo_train"] = parallel_olmo_training(mesh)
        free_device_memory()
        out["moe"] = parallel_moe(mesh)
        free_device_memory()
        out["mamba"] = parallel_smoke(mesh, "mamba2-1.3b", {"ssd_scan"})
        out["jamba"] = parallel_smoke(mesh, "jamba-1.5-large-398b",
                                      {"flash_attention", "ssd_scan"})
        out["mamba_train"] = parallel_mamba_training(mesh)
    return out


# the reference's production cells (configs/shapes.py) in bfloat16 on one
# card, for the archs it holds whole, at the rows of launch/cell_memory.py's
# ROWS: the largest power of two up to the cell's global batch
# (prefill_32k 32, decode_32k 128) whose bfloat16 weights and peak,
# reckoned from shapes, fit its 72 GB budget; both cells give the same rows
PROD_SEED = 0
PROD_CHECK_ROWS = 1      # rows of the prefills through the plain path
PROD_Q_SLAB = 256        # queries held against plain at each end of S
PROD_TRACED_STEP = 8     # the decode step traced by torch.profiler
PROD_TIMING_REPS = 5
# a bfloat16 kernel output at 32k against the plain version's, in bfloat16
# steps of the compared slab's largest |want|: both round float32 values
# that differ by far less than a step, so each element is off by at most
# one step of its own size; a second for the kernel's bfloat16
# probabilities (a relative 2**-9 a term, which average out over the keys)
PROD_SLAB_STEPS = 2
PROD_CHECK_SLICE = 32768  # positions of an SSD output compared at once
CARD_BYTES = 80e9


def step_at(top: float) -> float:
    """One bfloat16 step at a largest |value| ``top``: 2**(e - 7) for
    ``top`` in [2**e, 2**(e + 1))."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _max_abs(t: torch.Tensor) -> float:
    return float(t.float().abs().max()) if t.numel() else 0.0


def bf16_step(t: torch.Tensor) -> float:
    """One bfloat16 step at ``t``'s largest |value|."""
    return step_at(_max_abs(t))


def sliced_ssd_compare(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, max |want|, ``ssd_close`` in bfloat16 everywhere)
    of two (B, S, ...) tensors, taken ``PROD_CHECK_SLICE`` positions at a
    time: ``_max_err`` and ``ssd_close`` work in float64, and the long
    cell's whole y in float64 is 17.2 GB a copy."""
    err = top = 0.0
    close = True
    for i in range(0, want.shape[1], PROD_CHECK_SLICE):
        g, w = got[:, i:i + PROD_CHECK_SLICE], want[:, i:i + PROD_CHECK_SLICE]
        err, top = max(err, _max_err(g, w)), max(top, _max_abs(w))
        close = close and ssd_close(g, w, torch.bfloat16)
    return err, top, close


def own_size_ok(got: torch.Tensor, want: torch.Tensor, steps: int) -> tuple:
    """(max |got - want|, whether it is within ``steps`` bfloat16 steps of
    ``want``'s largest |value|)."""
    err = _max_err(got, want)
    return err, err <= steps * bf16_step(want)


def prod_logit_steps(cfg) -> int:
    """The logits' tolerance against the plain path, in bfloat16 steps of
    the plain logits' largest |value|: 3 sqrt(layers), rounded up.  The two
    paths differ only in the mixer: each layer's attention (or SSD) output
    is rounded to bfloat16 once on both, from float32 sums taken in
    different orders, so each layer adds about one step of its output to
    the hidden stream, with a sign of its own; such errors add as
    sqrt(layers).  The readings set the factor: on the H100 the five archs
    gave 0.43-2.21 sqrt(layers) steps (qwen2-moe-a2.7b's 10.81 steps at 24
    layers the largest, its routing flips included)."""
    return math.ceil(3 * math.sqrt(cfg.n_layers))


@contextlib.contextmanager
def in_place_of(module, name: str, fn):
    """``module.name`` replaced by ``fn`` for the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield fn
    finally:
        setattr(module, name, old)


def plain_ssd(x, dt, a_log, b_mat, c_mat, *, chunk, final_state=False):
    """The plain chunked SSD (``ref.ssd_chunked_ref``) in the kernel
    wrapper's place."""
    y, state = ref.ssd_chunked_ref(x, dt, a_log, b_mat, c_mat, chunk=chunk)
    return (y, state) if final_state else y


def plain_prefill(params, cfg, batch, max_len: int):
    """The bfloat16 prefill through the plain path: chunked attention, the
    plain chunked SSD; it must launch no kernel.  The attention takes the
    reference's wedge schedule (q chunk i visits kv chunks 0..i): the
    all-pairs schedule's other pairs, fully masked and visited after the
    diagonal, leave every value as it was (alpha 1, weights 0), so both
    give the same bits in half the pairs."""
    reset_launches()
    with in_place_of(M, "ssd_scan_cuda", plain_ssd):
        out = T.prefill(params, cfg.replace(attn_impl_train="wedge"),
                        batch, max_len, dtype=torch.bfloat16)
    check(not any(launches().values()),
          f"the plain prefill launched {launches()}")
    return out


def next_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy tokens as decode_step takes them: (B, 1), or (B, 1, K)."""
    return logits.argmax(-1).to(torch.int32).unsqueeze(1)


def rows_of(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()}


def compare_logits(label: str, got: torch.Tensor, want: torch.Tensor,
                   cfg, route: dict | None = None) -> dict:
    """``got`` (the kernel path's logits, one row) against ``want`` (the
    plain path's) within ``prod_logit_steps``; greedy tokens may flip only
    where the plain top two lie within that tolerance of each other, and
    the flips are counted.  ``route`` is the compared token's MoE route
    change (``mesh_checks.route_changes``), if its route differs between
    the paths: logits past the tolerance are then printed and counted, not
    failed, only where the change came first by a near tie (the two paths
    then compute another function from there on)."""
    got, want = whole(got), whole(want)
    steps = prod_logit_steps(cfg)
    step = bf16_step(want)
    err = _max_err(got, want)
    flips = got.argmax(-1) != want.argmax(-1)
    top2 = want.float().topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    print(f"  {label}: last logits vs the plain path max |err| {err:.6g} = "
          f"{err / step:.2f} bfloat16 steps of the largest |logit| "
          f"{float(want.float().abs().max()):.4f} (tol {steps} steps); "
          f"{int(flips.sum())} of {flips.numel()} greedy tokens flipped"
          + (f", at top-two gaps {gap[flips].tolist()}" if flips.any()
             else ""))
    held = err <= steps * step and not bool(
        (flips & (gap > steps * step)).any())
    excused = not held and route is not None and route["near_tie"]
    if excused:
        print(f"  {label}: past the tolerance, and the token's MoE route "
              f"changed first by a near tie (layer {route['layer']}, router "
              f"margins {route['margins']} within {route['tol']:.4g}): "
              "counted, not failed")
    else:
        check(err <= steps * step, f"{label}: logits differ by {err}"
              + (f"; the token's route changed ({route})" if route else ""))
        check(not bool((flips & (gap > steps * step)).any()),
              f"{label}: a greedy token flipped at a gap above the "
              "tolerance")
    return {"max_abs_err": err, "steps": err / step, "tol_steps": steps,
            "flips": int(flips.sum()), "route": route, "excused": excused}


def margin_tol(steps_of, cfg):
    """``route_changes``' tolerance of a router margin at layer ``l``:
    ``steps_of`` (a logits tolerance in bfloat16 steps, by config) of the
    model cut after layer l, in bfloat16 steps of the token's largest
    |router logit|: the router reads the hidden stream after layer l's
    mixer, perturbed as the logits would be by so many layers."""
    return lambda layer, lg: steps_of(cfg.replace(n_layers=layer + 1)) \
        * step_at(float(lg.abs().max()))


def check_call(kernel: str, label: str, args, kw, out) -> tuple:
    """One kernel call's output against the plain version on the same
    inputs: flash attention on the first and last ``PROD_Q_SLAB`` queries
    (``ref.flash_attention_ref`` with ``q_start``, without the (S, S)
    scores), the SSD's y and final state on the whole rows; within
    ``FLASH_TOL`` / ``SSD_TOL`` for bfloat16, and each held to its own
    size as well (``own_size_ok``), since at 32,768 keys a late query's
    output can be as small as those absolute tolerances.  Returns (max
    |err|, the largest error in bfloat16 steps of its own size, what to
    print)."""
    if kernel == "flash_attention":
        q, k, v = args
        s = q.shape[2]
        err, steps, slabs = 0.0, 0.0, []
        for start in (0, s - PROD_Q_SLAB):
            end = start + PROD_Q_SLAB
            want = ref.flash_attention_ref(
                q[:, :, start:end], k[:, :, :end], v[:, :, :end],
                q_start=start, **kw)
            got = out[:, :, start:end]
            e, ok = own_size_ok(got, want, PROD_SLAB_STEPS)
            check(flash_close(got, want, torch.bfloat16) and ok,
                  f"{label}: flash queries {start}..{end - 1} differ from "
                  f"plain by {e} (|o| up to {_max_abs(want)})")
            err, steps = max(err, e), max(steps, e / bf16_step(want))
            slabs.append(f"queries {start}..{end - 1}: max |err| {e:.3g} = "
                         f"{e / bf16_step(want):.2f} steps of |o| up to "
                         f"{_max_abs(want):.4g}")
            del want
        return err, steps, (
            f"{label} attention, kernel vs plain on its real q/k/v, of {s} "
            "positions: " + "; ".join(slabs) + f" (tol "
            f"{FLASH_TOL[torch.bfloat16]} abs + rel and {PROD_SLAB_STEPS} "
            "bfloat16 steps of the slab's largest |o|)")
    y, state = out
    want_y, want_state = ref.ssd_chunked_ref(*args, chunk=kw["chunk"])
    err_y, top_y, close_y = sliced_ssd_compare(y, want_y)
    del want_y
    err_s = _max_err(state, want_state)
    top_s = _max_abs(want_state)
    check(close_y and ssd_close(state, want_state, torch.bfloat16)
          and err_y <= PROD_SLAB_STEPS * step_at(top_y)
          and err_s <= SSD_TOL[torch.float32] * top_s,
          f"{label}: the SSD differs from the plain chunked SSD (y {err_y},"
          f" state {err_s})")
    steps = err_y / step_at(top_y)
    return max(err_y, err_s), steps, (
        f"{label} SSD, kernel vs plain chunked on its real inputs: y max "
        f"|err| {err_y:.3g} = {steps:.2f} steps of |y| up to "
        f"{top_y:.4g} (tol {PROD_SLAB_STEPS} steps), float32 "
        f"state max |err| {err_s:.3g} = {err_s / top_s:.3g} of |state| up "
        f"to {top_s:.4g} (tol {SSD_TOL[torch.float32]} of it); and tol "
        f"{SSD_TOL[torch.bfloat16]} abs + rel")


def check_layers(kernel: str, rec: RowRecorder, rows: tuple) -> dict:
    """``check_call`` on each call ``rec`` recorded (rows ``rows``)."""
    errs = {}
    for i, (args, kw, out) in sorted(rec.calls.items()):
        errs[i], _, text = check_call(kernel, f"layer {i}, rows {rows},",
                                      args, kw, out)
        print("  " + text)
    return errs


class EveryLayerCheck:
    """A pass-through around a kernel wrapper ``fn`` that holds every
    call's output against the plain version (``check_call``) as it goes,
    keeping only the errors: a fault in a middle layer shows here, where
    the logits of random weights cannot resolve it."""

    def __init__(self, fn, kernel: str):
        self.fn, self.kernel = fn, kernel
        self.errs: list = []     # (max |err|, steps of its own size)
        self.seconds = 0.0       # spent in the checks, between synchronises

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err, steps, _ = check_call(self.kernel, f"layer {len(self.errs)}",
                                   args, kw, out)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.errs.append((err, steps))
        return out


def prod_kernel_times(cfg, rows: int, s: int, kernel: str, gen,
                      cell: str = "prefill_32k", shards: int = 1) -> dict:
    """``cell``'s kernel at its prefill shape on seeded inputs laid out as
    the model hands them in: CUDA-event medians of ``PROD_TIMING_REPS``
    runs, the bound, scaled_dot_product_attention for flash (the plain
    version's (S, S) float32 scores, B H S^2 4 bytes, do not fit the card:
    its time is not measured) and the plain chunked SSD for the scan, with
    the scan kernel's grid against the card's SMs.  Flash takes the
    arch's window and, with ``shards``, one rank's heads of that many (the
    local shape of the sharded path)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=gen.device)
    dt_ = torch.bfloat16
    if kernel == "flash_attention":
        hq, hkv, d = (T._dims(cfg).n_q_phys // shards,
                      T._dims(cfg).n_kv_phys // shards, cfg.d_head)
        window = cfg.swa_window
        q, k, v = (torch.randn((rows, s, h, d), generator=gen,
                               device=gen.device, dtype=dt_).transpose(1, 2)
                   for h in (hq, hkv, hkv))

        def call():
            return fa.flash_attention_cuda(q, k, v, swa_window=window)
        ms = event_ms(call, flush, PROD_TIMING_REPS)
        lib_ms = sdpa_ms(q, k, v, window, flush)
        plain_ms = None
        bound, by, flops, nbytes = flash_bound(rows, hq, hkv, s, d, dt_,
                                               window)
        shape = [rows, hq, hkv, s, d] + ([window] if window else [])
        load = clock_under_load(call)
    else:
        sc = cfg.ssm
        h, g, p, n = sc.n_heads, sc.n_groups, sc.head_dim, sc.d_state
        x = torch.randn((rows, s, h * p), generator=gen, device=gen.device,
                        dtype=dt_).reshape(rows, s, h, p)
        dt = 0.01 + 0.49 * torch.rand((rows, s, h), generator=gen,
                                      device=gen.device)
        a_log = 2 * torch.rand(h, generator=gen, device=gen.device) - 1
        bc = torch.randn((rows, s, 2 * g * n), generator=gen,
                         device=gen.device, dtype=dt_)
        args = (x, dt, a_log, bc[..., :g * n].reshape(rows, s, g, n),
                bc[..., g * n:].reshape(rows, s, g, n))

        def call():
            return ss.ssd_scan_cuda(*args, final_state=True)
        ms = event_ms(call, flush, PROD_TIMING_REPS)
        plain_ms = event_ms(lambda: ref.ssd_chunked_ref(*args,
                                                        chunk=sc.chunk),
                            flush, PROD_TIMING_REPS)
        lib_ms = None
        bound, by, flops, nbytes = ssd_bound(rows, s, h, g, p, n, dt_)
        shape = [rows, s, h, g, p, n]
        load = clock_under_load(call)
        grid = {"ctas": ss.ctas(rows, s, h, g, p),
                "ctas_per_sm": ss.occupancy(dt_, p, n)["ctas_per_sm"],
                "sms": torch.cuda.get_device_properties(0)
                .multi_processor_count}
        load.update(grid)
        waves = grid["ctas"]["scan"] / (grid["ctas_per_sm"] * grid["sms"])
        print(f"  ssd_scan at {shape}: the scan kernel's "
              f"{grid['ctas']['scan']} CTAs a call (ss.ctas; C B^T "
              f"{grid['ctas']['cb']}), {grid['ctas_per_sm']} an SM at once "
              f"(occupancy API), on {grid['sms']} SMs: {waves:.3f} waves, "
              f"each CTA scanning {ss.n_chunks(s)} chunks of "
              f"{ref.SSD_CHUNK} rows in series")
    print(f"  {kernel} bfloat16 at {cfg.name}'s {cell} shape {shape}: "
          f"kernel {ms:.6f} ms, bound {bound:.6f} ms ({by}: {flops} FLOP, "
          f"{nbytes} bytes) = {100 * bound / ms:.4f}% of the bound; plain "
          + (f"{plain_ms:.6f} ms" if plain_ms is not None else
             "not measured (its (S, S) float32 scores do not fit the card)")
          + (f"; scaled_dot_product_attention {lib_ms:.6f} ms (yardstick "
             "only)" if lib_ms is not None else "")
          + f"; SM clock {load['sm_mhz']:.0f} MHz and board power "
          f"{load['power_w']:.1f} W while it runs back to back (nvidia-smi, "
          "median)")
    return {"dtype": "bfloat16", "path": f"{cfg.name} {cell}",
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "flops": flops, "bytes": nbytes, "share": bound / ms, **load}


def production_cells(arch: str) -> dict:
    """``arch``'s prefill_32k and decode_32k cells in bfloat16 (see
    ``phase_production_cells``)."""
    free_device_memory()
    dev = torch.device("cuda")
    cfg = get_arch(arch, attn_impl_train="pallas")
    kernel, target, staged, source = kernel_entry(cfg)
    rows, n_layers = cell_memory.ROWS[arch], cfg.n_layers
    s = SHAPES["prefill_32k"].seq_len
    steps = cell_memory.DECODE_STEPS
    gen = torch.Generator(device=dev).manual_seed(PROD_SEED)
    params, init_s = sync_seconds(lambda: T.init_params(
        cfg, gen, dtype=torch.bfloat16, device=dev))
    batch = cell_memory.prefill_inputs(cfg, rows, s, dev, gen)
    print(f"production cells: {arch} ({n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}x{cfg.d_head} heads, vocab "
          f"{cfg.vocab}), {int(cfg.param_count())} bfloat16 parameters "
          f"(random, seed {PROD_SEED}, init {init_s:.3f} s), {rows} rows of "
          f"the cells' {SHAPES['prefill_32k'].global_batch} / "
          f"{SHAPES['decode_32k'].global_batch} (launch/cell_memory.py)")
    out = {"rows": rows, "kernel": kernel}

    # (a) prefill_32k: S positions into an S-position cache
    rec = RowRecorder(target[2], (0, n_layers - 1), (0, rows - 1),
                      staged)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with in_place_of(target[0], target[1], rec):
        (logits, cache), wall = sync_seconds(lambda: T.prefill(
            params, cfg, batch, s, dtype=torch.bfloat16))
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(counts[kernel] == n_layers and sum(counts.values()) == n_layers,
          f"{arch} prefill_32k launched {counts}, not {kernel} once a layer")
    check(rec.n == n_layers, f"{arch}: {rec.n} {kernel} calls")
    v_shape = (rows, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks \
        else (rows, cfg.vocab)
    check(logits.dtype == torch.bfloat16 and tuple(logits.shape) == v_shape
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {logits.dtype} {tuple(logits.shape)}")
    want_leaves = flatten(T.cache_leaf_shapes(cfg, rows, s,
                                              torch.bfloat16)["blocks"])
    got_leaves = flatten(cache["blocks"])
    check(cache["pos"] == s and all(
        tuple(got_leaves[k].shape) == w.shape and got_leaves[k].dtype
        == w.dtype for k, w in want_leaves.items()),
        f"{arch}: the cache is not the bfloat16 cache of {s} positions")
    cache_b = sum(t.numel() * t.element_size() for t in got_leaves.values())
    check(peak < CARD_BYTES, f"{arch} prefill_32k peak {peak} B")
    print(f"  prefill_32k: {rows} x {s} positions in {wall:.6f} s "
          f"({rows * s / wall:.1f} tokens/s), {counts[kernel]} {kernel} "
          f"launches on the bfloat16 route ({source}); cache {cache_b} B; "
          f"peak {peak} B ({rec.held_bytes()} B of it the recorded rows of "
          f"layers 0 and {n_layers - 1}); inputs copied before the kernel "
          f"{rec.copied} B in all")
    out["prefill"] = {"wall_s": wall, "tokens_per_s": rows * s / wall,
                      "peak_bytes": peak, "launches": counts[kernel],
                      "cache_bytes": cache_b, "copied_bytes": rec.copied}
    del cache, got_leaves
    out["layer_err"] = check_layers(kernel, rec, (0, rows - 1))
    del rec
    got_a = logits[:PROD_CHECK_ROWS].clone()
    del logits

    # (b) decode_32k: S - steps positions into an S-position cache, then
    # ``steps`` greedy steps, the last against the whole cache
    short = {k: v[:, :v.shape[1] - steps] if k == "tokens" else v
             for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (logits, cache), wall_b = sync_seconds(lambda: T.prefill(
        params, cfg, short, s, dtype=torch.bfloat16))
    counts = launches()
    check(counts[kernel] == n_layers and sum(counts.values()) == n_layers,
          f"{arch} decode_32k prefill launched {counts}")
    check(cache["pos"] == s - steps, f"{arch}: cache at {cache['pos']}")
    first_tok = next_tokens(logits)
    del logits
    got_b, walls, busy_s, cache = decode_run(params, cfg, first_tok, cache,
                                             steps, f"{arch} decode_32k")
    peak_b = torch.cuda.max_memory_allocated()
    check(cache["pos"] == s, f"{arch}: decode ended at {cache['pos']}")
    check(peak_b < CARD_BYTES, f"{arch} decode_32k peak {peak_b} B")
    step_ms = 1e3 * float(np.median(walls))
    print(f"  decode_32k: prefill of {rows} x {s - steps} positions in "
          f"{wall_b:.6f} s ({n_layers} {kernel} launches), then {steps} "
          f"greedy steps up to position {s - 1} (the last over all {s} "
          f"cache positions): no launch; a step {step_ms:.3f} ms median "
          f"(untraced steps {[round(1e3 * w, 3) for w in walls]} ms), "
          f"{rows / step_ms * 1e3:.1f} tokens/s; peak {peak_b} B")
    out["decode"] = {"prefill_wall_s": wall_b, "launches": n_layers,
                     "step_ms": step_ms,
                     "step_ms_all": [1e3 * w for w in walls],
                     "tokens_per_s": rows / step_ms * 1e3,
                     "peak_bytes": peak_b, "traced_busy_s": busy_s}
    out["launches_by_path"] = {
        f"{arch} {name}_32k bfloat16": out[name]["launches"]
        for name in ("prefill", "decode")}
    del cache
    out.update(plain_checks(params, cfg, batch, got_a, got_b,
                            first_tok[:PROD_CHECK_ROWS], target))
    out["times"] = prod_kernel_times(cfg, rows, s, kernel, gen)
    del params, batch, short
    return out


def kernel_entry(cfg) -> tuple:
    """(kernel, (module, name, wrapper) of its entry on the model's path,
    the arguments the wrapper may copy before its kernel, its source) of a
    production cell's arch, whose layers all run one kernel."""
    kernels = {MIXER_KERNEL[spec.mixer] for spec in cfg.pattern}
    check(len(kernels) == 1, f"{cfg.name} runs {kernels}")
    (kernel,) = kernels
    if kernel == "flash_attention":
        return (kernel, (ops, "flash_attention_cuda",
                         fa.flash_attention_cuda), (0, 1, 2),
                fa.route(torch.bfloat16))
    return kernel, (M, "ssd_scan_cuda", ss.ssd_scan_cuda), (0, 3, 4), \
        ss.SOURCE


def decode_run(params, cfg, tok, cache, steps: int, label: str,
               wrap=None) -> tuple:
    """``steps`` greedy decode steps from the tokens ``tok`` on ``cache``,
    step ``PROD_TRACED_STEP`` traced, none of them launching a kernel:
    (the first step's logits on ``PROD_CHECK_ROWS`` rows, the untraced
    steps' walls, the traced step's device seconds, the cache).  On the
    sharded path ``wrap`` lays each step's greedy tokens out for the next
    (the logits are taken whole)."""
    reset_launches()
    walls, first, busy_s = [], None, None
    for i in range(steps):
        def step():
            return T.decode_step(params, cfg, tok, cache)
        if i == PROD_TRACED_STEP:
            (logits, cache), busy_s = step_profile(
                step, float(np.median(walls)), f"{label} step {i} at "
                f"position {cache['pos']}")
        else:
            (logits, cache), w = sync_seconds(step)
            walls.append(w)
        logits = whole(logits)
        check(bool(torch.isfinite(logits).all()),
              f"{label} step {i}: logits not finite")
        if i == 0:
            first = logits[:PROD_CHECK_ROWS].clone()
        tok = next_tokens(logits)
        if wrap is not None:
            tok = wrap(tok)
    check(not any(launches().values()), f"{label} launched {launches()}")
    return first, walls, busy_s, cache


def plain_checks(params, cfg, batch, got_a, got_b, tok, target,
                 moe_routes: bool = False) -> dict:
    """Both cells' logits on ``PROD_CHECK_ROWS`` rows against the plain
    path's: ``got_a`` (prefill_32k's last logits) and ``got_b``
    (decode_32k's first step, on the greedy tokens ``tok``); and, in a
    prefill of those rows through the kernel path, every layer's kernel
    call against the plain version (``EveryLayerCheck`` in place of the
    entry ``target``, (module, name, wrapper)).

    An attention-only model's decode_32k cache is its prefill_32k cache of
    the same prompt rolled back to position S - steps: K and V at a
    position depend on the tokens up to it alone (causal attention), and a
    decode step writes its own slot before it attends, masking every later
    one; so one plain prefill of S positions serves both cells there.  A
    Mamba layer's cache is its state at the prompt's end, so mamba2-1.3b
    prefills its S - steps positions through the plain path again.  An
    MoE's capacity, and so its drops, depend on the rows dispatched
    together: its logits are the kernel path's on the plain's rows, rolled
    back the same way where the capacity of S and of S - steps tokens
    rounds to the same (a slot's rank counts only earlier tokens).  With
    ``moe_routes`` an MoE's routes are recorded on both paths, and a
    compared token whose route changed first by a near tie is counted and
    its logits not held (``compare_logits``)."""
    s = SHAPES["prefill_32k"].seq_len
    steps = cell_memory.DECODE_STEPS
    rows = rows_of(batch, PROD_CHECK_ROWS)
    short = {k: v[:, :v.shape[1] - steps] if k == "tokens" else v
             for k, v in rows.items()}
    rollback = all(spec.mixer == "attn" for spec in cfg.pattern) \
        and not cfg.swa_window and (cfg.moe is None or MOE._capacity(
            s * PROD_CHECK_ROWS, cfg.moe) == MOE._capacity(
                (s - steps) * PROD_CHECK_ROWS, cfg.moe))

    def decode_cache(prefill_fn, cache):
        """The decode_32k cache: ``cache`` rolled back, or a prefill of
        the S - steps positions."""
        if rollback:
            cache["pos"] = s - steps
            return cache
        del cache
        return prefill_fn(short)[1]

    def kernel_prefill(b):
        return T.prefill(params, cfg, b, s, dtype=torch.bfloat16)
    kernel = MIXER_KERNEL[cfg.pattern[0].mixer]
    every = EveryLayerCheck(target[2], kernel)
    record = moe_routes and cfg.moe is not None
    routes = {"kernel": RouteRecorder(), "plain": RouteRecorder()}
    side = (lambda name: in_place_of(MOE, "_route", routes[name])) \
        if record else (lambda name: contextlib.nullcontext())
    with in_place_of(target[0], target[1], every), side("kernel"):
        got_row, kcache = kernel_prefill(rows)
    check(len(every.errs) == cfg.n_layers,
          f"{len(every.errs)} {kernel} calls in a {cfg.n_layers}-layer "
          "prefill")
    worst = max(range(cfg.n_layers), key=lambda i: every.errs[i][1])
    print(f"  every layer's {kernel} call in a prefill of {PROD_CHECK_ROWS}"
          f" row(s) of {s} positions, against the plain version on its "
          f"inputs: all {cfg.n_layers} held; the largest error "
          f"{every.errs[worst][1]:.2f} bfloat16 steps of its own size "
          f"(layer {worst}, max |err| {every.errs[worst][0]:.3g}; tol "
          f"{PROD_SLAB_STEPS})")
    out = {"every_layer_err": [e for e, _ in every.errs],
           "every_layer_steps": [st for _, st in every.errs]}
    if cfg.moe is not None:
        got_a = got_row
        with side("kernel"):
            kcache = decode_cache(kernel_prefill, kcache)
            got_b = T.decode_step(params, cfg, tok, kcache)[0]
    del kcache, got_row
    with side("plain"):
        (want, pcache), plain_s = sync_seconds(lambda: plain_prefill(
            params, cfg, rows, s))
    changed = [None, None]
    pl_label = (f"prefill_32k, {PROD_CHECK_ROWS} row(s) through the plain "
                f"path ({plain_s:.3f} s)")
    with side("plain"):
        pcache = decode_cache(lambda b: plain_prefill(params, cfg, b, s),
                              pcache)
        want_b = T.decode_step(params, cfg, tok, pcache)[0]
    del pcache
    if record:
        calls = [s] + ([] if rollback else [s - steps]) + [1]
        changes = mesh_checks.route_changes(
            routes["kernel"].routes, routes["plain"].routes, calls,
            cfg.n_layers, cfg.moe.top_k, margin_tol(prod_logit_steps, cfg))
        changed = [next(iter(c["rows"]), None)
                   for c in (changes[0], changes[-1])]
        out["route_changes"] = [{k: c[k] for k in ("expert_slots",
                                                   "keep_slots")}
                                for c in changes]
        print(f"  MoE routes, kernel path against plain, by call: "
              f"{out['route_changes']} (token, slot)s whose expert or "
              f"capacity keep alone differ; the compared tokens' first "
              f"changes: prefill {changed[0]}, decode {changed[1]}")
    out.update(plain_wall_s=plain_s, prefill_logits=compare_logits(
        pl_label, got_a, want, cfg, changed[0]))
    out["decode_logits"] = compare_logits(
        f"decode_32k first step, {PROD_CHECK_ROWS} row(s) after a prefill "
        "through the plain path" + (" (rolled back)" if rollback else ""),
        got_b, want_b, cfg, changed[1])
    return out


def long_cell(arch: str) -> dict:
    """``arch``'s long_500k cell in bfloat16 (see
    ``phase_production_cells``).  Its one row is the plain checks' row, so
    ``EveryLayerCheck`` wraps the cell's own prefill (no second kernel
    prefill, no ``RowRecorder``: rows 0 and 0 of two layers would hold
    about 17 GB of SSD inputs and outputs beside the prefill's own peak),
    and its per-layer checks compare y a slice at a time
    (``sliced_ssd_compare``)."""
    free_device_memory()
    dev = torch.device("cuda")
    cfg = get_arch(arch, attn_impl_train="pallas")
    kernel, target, _, source = kernel_entry(cfg)
    cell = SHAPES["long_500k"]
    rows, n_layers = cell_memory.LONG_ROWS[arch], cfg.n_layers
    s, steps = cell.seq_len, cell_memory.DECODE_STEPS
    check(rows == PROD_CHECK_ROWS, f"{arch} long_500k at {rows} rows: the "
          f"checks wrap its prefill, which must be of {PROD_CHECK_ROWS}")
    gen = torch.Generator(device=dev).manual_seed(PROD_SEED)
    params, init_s = sync_seconds(lambda: T.init_params(
        cfg, gen, dtype=torch.bfloat16, device=dev))
    batch = cell_memory.prefill_inputs(cfg, rows, s - steps, dev, gen)
    got = cell_memory.reckon(cfg, cell, rows)
    print(f"production cells: {arch} long_500k ({n_layers} layers, "
          f"d_model {cfg.d_model}), {int(cfg.param_count())} bfloat16 "
          f"parameters (random, seed {PROD_SEED}, init {init_s:.3f} s), "
          f"{rows} row of the cell's {cell.global_batch}; reckoned "
          f"(launch/cell_memory.py) {got['total']} B: weights "
          f"{got['params']} B, cache {got['cache']} B, peak {got['peak']} B")

    # the prefill: S - steps positions into an S-position cache, each
    # layer's kernel call held against the plain version as it goes
    every = EveryLayerCheck(target[2], kernel)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with in_place_of(target[0], target[1], every):
        (logits, cache), wall = sync_seconds(lambda: T.prefill(
            params, cfg, batch, s, dtype=torch.bfloat16))
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(counts[kernel] == n_layers and sum(counts.values()) == n_layers,
          f"{arch} long_500k launched {counts}, not {kernel} once a layer")
    check(len(every.errs) == n_layers,
          f"{len(every.errs)} {kernel} calls in a {n_layers}-layer prefill")
    check(logits.dtype == torch.bfloat16
          and tuple(logits.shape) == (rows, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{arch} long_500k logits {logits.dtype} {tuple(logits.shape)}")
    want_leaves = flatten(T.cache_leaf_shapes(cfg, rows, s,
                                              torch.bfloat16)["blocks"])
    got_leaves = flatten(cache["blocks"])
    check(cache["pos"] == s - steps and all(
        tuple(got_leaves[k].shape) == w.shape and got_leaves[k].dtype
        == w.dtype for k, w in want_leaves.items()),
        f"{arch}: the cache is not the bfloat16 cache of {s} positions")
    cache_b = sum(t.numel() * t.element_size() for t in got_leaves.values())
    del got_leaves
    check(peak < CARD_BYTES, f"{arch} long_500k prefill peak {peak} B")
    own_s = wall - every.seconds
    worst = max(range(n_layers), key=lambda i: every.errs[i][1])
    print(f"  long_500k prefill: {rows} x {s - steps} positions in "
          f"{wall:.6f} s, {every.seconds:.6f} s of it the per-layer checks "
          f"against the plain version, so {own_s:.6f} s "
          f"({rows * (s - steps) / own_s:.1f} tokens/s) without them; "
          f"{counts[kernel]} {kernel} launches on the bfloat16 route "
          f"({source}); cache {cache_b} B (reckoned {got['cache']} B); peak "
          f"{peak} B with the checks' plain outputs, weights included "
          f"(reckoned {got['total']} B without them)")
    print(f"  every layer's {kernel} call in it against the plain version "
          f"on its inputs: all {n_layers} held; the largest error "
          f"{every.errs[worst][1]:.2f} bfloat16 steps of its own size "
          f"(layer {worst}, max |err| {every.errs[worst][0]:.3g}; tol "
          f"{PROD_SLAB_STEPS})")
    got_a = logits[:PROD_CHECK_ROWS].clone()
    first_tok = next_tokens(logits)
    del logits

    # ``steps`` greedy steps up to position S - 1
    torch.cuda.reset_peak_memory_stats()
    got_b, walls, busy_s, cache = decode_run(params, cfg, first_tok, cache,
                                             steps, f"{arch} long_500k")
    peak_b = torch.cuda.max_memory_allocated()
    check(cache["pos"] == s, f"{arch}: decode ended at {cache['pos']}")
    del cache
    step_ms = 1e3 * float(np.median(walls))
    print(f"  long_500k decode: {steps} greedy steps from position "
          f"{s - steps} up to {s - 1}: no launch; a step {step_ms:.3f} ms "
          f"median (untraced steps {[round(1e3 * w, 3) for w in walls]} "
          f"ms), {rows / step_ms * 1e3:.1f} tokens/s; peak {peak_b} B")

    # the same prefill and first step through the plain path
    (want, pcache), plain_s = sync_seconds(lambda: plain_prefill(
        params, cfg, batch, s))
    prefill_logits = compare_logits(
        f"long_500k prefill, through the plain path ({plain_s:.3f} s)",
        got_a, want, cfg)
    want = T.decode_step(params, cfg, first_tok, pcache)[0]
    del pcache
    decode_logits = compare_logits(
        "long_500k first decode step, after the plain prefill", got_b,
        want, cfg)
    times = prod_kernel_times(cfg, rows, s, kernel, gen, cell="long_500k")
    del params, batch
    return {"rows": rows, "kernel": kernel, "reckoned": got,
            "prefill": {"wall_s": wall, "check_s": every.seconds,
                        "tokens_per_s": rows * (s - steps) / own_s,
                        "peak_bytes": peak, "launches": counts[kernel],
                        "cache_bytes": cache_b},
            "decode": {"step_ms": step_ms,
                       "step_ms_all": [1e3 * w for w in walls],
                       "tokens_per_s": rows / step_ms * 1e3,
                       "peak_bytes": peak_b, "traced_busy_s": busy_s},
            "launches_by_path": {f"{arch} long_500k bfloat16":
                                 counts[kernel]},
            "layer_err": {}, "every_layer_err": [e for e, _ in every.errs],
            "every_layer_steps": [st for _, st in every.errs],
            "plain_wall_s": plain_s, "prefill_logits": prefill_logits,
            "decode_logits": decode_logits, "times": times}


def phase_production_cells() -> dict:
    """The reference's production cells on the card: for each arch of
    ``cell_memory.ROWS`` (``get_arch(arch, attn_impl_train="pallas")``,
    bfloat16 weights from a seed), ``prefill_32k`` (``T.prefill`` of 32,768
    positions, pixtral-12b's first 1,024 of them patches, into a bfloat16
    cache) with one bfloat16 kernel launch a layer, layers 0 and last's
    kernel outputs on rows 0 and B-1 against the plain version on their
    real inputs, the last logits against a prefill through the plain path
    (chunked attention, in the wedge schedule; the plain chunked SSD) on
    ``PROD_CHECK_ROWS`` rows,
    argmax flips counted, and every layer's kernel call in a kernel-path
    prefill of those rows against the plain version; and ``decode_32k`` (a prefill of 32,752
    positions, then 16 greedy ``decode_step``s up to position 32,767, one
    traced) with no launch in decode and the first step's logits against
    the same step after the plain prefill; walls, peaks under 80 GB, and
    the kernel timed at the cell's shape beside its bound.  Then each arch
    of ``cell_memory.LONG_ROWS`` in ``long_500k`` (``long_cell``): a
    prefill of 524,272 positions with every layer's kernel call held
    against the plain version, 16 greedy steps up to position 524,287
    with no launch, one traced, its prefill's and first step's logits
    against the plain path's, its peak beside ``cell_memory.reckon``'s,
    and the kernel timed at (1, 524,288) with the scan's grid."""
    out = {arch: production_cells(arch) for arch in cell_memory.ROWS}
    out.update({f"{arch} long_500k": long_cell(arch)
                for arch in cell_memory.LONG_ROWS})
    return out


def phase_times(main: dict, worst: dict) -> list:
    toks = main["first_chunk"]                  # (256, 2048, 256) int32
    k = main["k"]
    nb, rows, length = toks.shape
    sampled = toks[:, :k].contiguous()
    lens = torch.full((nb,), k, dtype=torch.int32, device=toks.device)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=toks.device)
    batched = (bs.block_stats_batched_cuda, ref.block_stats_batched_ref)
    single = (bs.block_stats_cuda, ref.block_stats_ref)
    pat_bytes = len(PATTERN) * 4
    shapes = {  # name -> (label, (kernel, plain), args, bytes read + written)
        "block_stats_batched": [
            ("sampled", batched, (sampled, lens, PATTERN),
             nb * k * length * 4 + nb * 4 + pat_bytes + nb * 12),
            ("full", batched, (toks, None, PATTERN),
             nb * rows * length * 4 + pat_bytes + nb * 12)],
        "block_stats": [
            ("one block", single, (toks[0], PATTERN),
             rows * length * 4 + pat_bytes + 12)],
    }
    (built,) = _build.build(bs.SOURCE)
    usage = ptxas_usage(built.log, "block_stats_kernel")
    facts = bs.occupancy(toks.device.index)
    print(f"  block_stats kernel: {usage['registers']} registers a thread, "
          f"spills {usage['spill_stores']} B stored / {usage['spill_loads']} "
          f"B loaded (ptxas), {facts['threads']} threads and "
          f"{facts['smem_bytes']} B of dynamic shared memory a CTA, "
          f"{facts['ctas_per_sm']} CTA(s) an SM on {facts['sms']} SMs, "
          f"clusters up to {facts['max_cluster']} CTAs "
          f"({facts['max_active_clusters']} of them at once) (occupancy API)")
    entries = []
    for name, cases in shapes.items():
        per_shape = []
        for label, (kernel, plain), args, nbytes in cases:
            x = args[0]
            err = _max_err(kernel(*args), plain(*args))
            check(err == 0.0, f"{name} [{label}] differs from plain by {err}")
            worst[name] = max(worst[name], err)

            def call():
                return kernel(*args)
            ms = event_ms(call, flush)
            plain_ms = event_ms(lambda: plain(*args), flush)
            read_ms = event_ms(lambda: torch.sum(x, dtype=torch.int64), flush)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            cluster, clusters = bs.launch_shape(
                *(x.shape if x.dim() == 3 else (1, *x.shape)),
                facts["slots"], facts["max_cluster"])
            events = device_events(call)
            check(all(len(names) in (DEVICE_CALLS - 1, DEVICE_CALLS)
                      and all("block_stats_kernel" in n for n in names)
                      for names in events),
                  f"{name} [{label}]: {DEVICE_CALLS} calls recorded "
                  f"{events}, not one block_stats_kernel a call")
            load = clock_under_load(call)
            host = x.cpu().numpy()
            _, copy_s = sync_seconds(
                lambda: torch.from_numpy(host).to(toks.device))
            per_shape.append({"label": label, "shape": list(x.shape),
                              "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "share": bound / ms,
                              "read_yardstick_ms": read_ms,
                              "cluster": cluster, "ctas": cluster * clusters,
                              "device_kernels_a_call": 1, **load,
                              "h2d_copy_s": copy_s})
            print(f"  {name} [{label}] {tuple(x.shape)}: kernel {ms:.6f} ms, "
                  f"plain {plain_ms:.6f} ms, bound {bound:.6f} ms (bytes, "
                  f"{nbytes} at 3.35 TB/s) = {100 * bound / ms:.4f}% of the "
                  f"bound; host->device copy {copy_s:.6f} s; no single "
                  "PyTorch call computes these statistics (library_ms null)")
            print(f"    read yardstick, not the same function: torch.sum(x, "
                  f"dtype=torch.int64) {read_ms:.6f} ms; clusters of "
                  f"{cluster}, {cluster * clusters} CTAs; 1 device kernel a "
                  f"call ({events[-1][0]}); SM clock {load['sm_mhz']:.0f} MHz "
                  f"and board power {load['power_w']:.1f} W while it runs back "
                  "to back (nvidia-smi, median)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + bs.SOURCE,
            "replaces": KERNELS[name],
            "launches": main["launches"][name],
            "max_abs_err": worst[name],
            "ms": sum(s["ms"] for s in per_shape),
            "plain_ms": sum(s["plain_ms"] for s in per_shape),
            "bound_ms": sum(s["bound_ms"] for s in per_shape),
            "bound_by": "bytes", "library_ms": None,
            "ptxas": usage, **{k: facts[k] for k in (
                "threads", "smem_bytes", "ctas_per_sm", "max_cluster")},
            "per_shape": per_shape})
    return entries


def sdpa_ms(q, k, v, window, flush) -> float | None:
    """CUDA-event median of ``scaled_dot_product_attention`` computing
    causal attention (within ``window``) on ``q, k, v``, a yardstick: with
    no window its causal flag (GQA enabled); with one, k and v expanded to
    q's heads and the window as a boolean (S, S) mask, on the
    memory-efficient backend only (the math backend would hold B H S^2
    float32 scores); None where that backend refuses."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return event_ms(lambda: sdpa(q, k, v, is_causal=True,
                                     enable_gqa=q.shape[1] != k.shape[1]),
                        flush, PROD_TIMING_REPS)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s, rep = q.shape[2], q.shape[1] // k.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    ke, ve = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return event_ms(lambda: sdpa(q, ke, ve, attn_mask=mask), flush,
                            PROD_TIMING_REPS)
    except RuntimeError as e:
        print(f"  scaled_dot_product_attention with a window mask not timed:"
              f" {str(e).splitlines()[0]}")
        return None


def flash_bound(b, hq, hkv, s, d, dtype, window=None) -> tuple:
    """(bound ms, "operations" or "bytes", flops, bytes) of causal attention
    at this shape: 4*D operations a visible (query, key) pair (query i sees
    min(i + 1, ``window``) keys) at the type's peak rate; q, k, v read once
    and o written once at the memory rate."""
    w = min(window or s, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 4 * d * b * hq * pairs
    nbytes = (2 * b * hq + 2 * b * hkv) * s * d * dtype.itemsize
    rate = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def ptxas_usage(log: str, entry: str) -> dict:
    """Registers and spill bytes that ``-Xptxas -v`` printed for the first
    entry function whose mangled name contains ``entry``."""
    usage, inside = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            if inside:
                break
            inside = entry in line
        elif inside and "spill stores" in line:
            words = line.split()
            usage.setdefault("spill_stores",
                             int(words[words.index("spill") - 2]))
            usage.setdefault("spill_loads", int(words[-4]))
        elif inside and "Used" in line and "registers" in line:
            words = line.split()
            usage.setdefault("registers", int(words[words.index("Used") + 1]))
    check({"registers", "spill_stores", "spill_loads"} <= set(usage),
          f"no ptxas usage for {entry} in the build log")
    return usage


def device_kernels(fn) -> list:
    """Names of the CUDA kernels that ``fn()`` launches, as torch.profiler
    records them over ``device_events``."""
    return sorted({name for names in device_events(fn) for name in names})


DEVICE_CALLS = 4
SPIN_CYCLES = 2_000_000      # about 1 ms of torch.cuda._sleep at 1980 MHz


def device_events(fn) -> list:
    """For two torch.profiler sessions of ``DEVICE_CALLS`` calls of ``fn``
    each, the names of the device events (kernels, copies, memsets) they
    recorded.  Sessions have missed the first kernels launched in them (one
    of four, two of four, now and then all), so each session is ``traced``
    (after a warm-up step whose events the profiler drops) and first runs a
    spin kernel of about 1 ms, the calls running on the device after it;
    its event and the step's own range (``ProfilerStep#``) are left out.  A session that still recorded fewer events than
    ``DEVICE_CALLS - 1`` (every call launches at least one kernel) is run
    again, up to six sessions in all."""
    def run():
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(DEVICE_CALLS):
            fn()
    sessions, recorded = [], []
    for _ in range(6):
        names = [e.name for e in traced(run).events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name
                 and not e.name.startswith("ProfilerStep")]
        recorded.append(len(names))
        if len(names) >= DEVICE_CALLS - 1:
            sessions.append(names)
        if len(sessions) == 2:
            return sessions
    raise RuntimeError("chip_smoke: six profiler sessions, fewer than two "
                       f"recorded {DEVICE_CALLS - 1} device events or more "
                       f"(they recorded {recorded})")


def clock_under_load(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and board power (W) that nvidia-smi samples
    every 100 ms on this process's card while ``fn`` runs back to back for
    ``seconds``."""
    smi = subprocess.Popen(["nvidia-smi", "-i",
                            str(torch.cuda.current_device()),
                            "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    rows = [[float(x) for x in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]
    check(len(rows) > 2, "nvidia-smi gave no clock samples")
    mhz, watts = zip(*rows[1:])        # the first sample precedes the load
    return {"sm_mhz": float(np.median(mhz)), "power_w": float(np.median(watts))}


def phase_flash_times(paths: dict, worst: dict) -> dict:
    b, h, s, d = SERVE["batch"], 16, SERVE["prompt"], 128   # olmo-1b prefill
    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    per_shape = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(rng, b, h, h, s, d, dtype)
        got = fa.flash_attention_cuda(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        lib = sdpa(q, k, v, is_causal=True)
        err = _max_err(got, want)
        check(flash_close(got, want, dtype),
              f"flash {dtype} at the main shape differs by {err}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        ms = event_ms(lambda: fa.flash_attention_cuda(q, k, v), flush)
        plain_ms = event_ms(lambda: ref.flash_attention_ref(q, k, v), flush)
        lib_ms = event_ms(lambda: sdpa(q, k, v, is_causal=True), flush)
        bound, by, flops, nbytes = flash_bound(b, h, h, s, d, dtype)
        source = fa.route(dtype)
        (built,) = _build.build(source)
        kernel = "flash_bf16_kernel" if dtype == torch.bfloat16 \
            else "flash_f32_kernel"
        design = {**ptxas_usage(built.log, f"{kernel}ILi{d}E"),
                  **fa.occupancy(dtype, d)}
        lib_kernels = device_kernels(lambda: sdpa(q, k, v, is_causal=True))
        load = clock_under_load(lambda: fa.flash_attention_cuda(q, k, v))
        per_shape.append({"dtype": str(dtype)[6:], "shape": [b, h, s, d],
                          "source": "src/repro_torch/kernels/csrc/" + source,
                          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bound, "bound_by": by, "flops": flops,
                          "bytes": nbytes, "share": bound / ms,
                          "max_abs_err": err,
                          "library_max_abs_err": _max_err(lib, want),
                          "library_kernels": lib_kernels, **design,
                          **load})
        print(f"  flash_attention {str(dtype)[6:]} (B,H,S,D)=({b},{h},{s},"
              f"{d}) causal, transposed views: kernel {ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, scaled_dot_product_attention {lib_ms:.6f} "
              f"ms (yardstick only), bound {bound:.6f} ms ({by}: {flops} "
              f"FLOP, {nbytes} bytes) = {100 * bound / ms:.4f}% of the bound;"
              f" max |err| {err:.3g}")
        print(f"    route {source}: {design['registers']} registers a "
              f"thread, spills {design['spill_stores']} B stored / "
              f"{design['spill_loads']} B loaded (ptxas), "
              f"{design['threads']} threads and "
              f"{design['smem_bytes']} B of dynamic shared memory a CTA, "
              f"{design['ctas_per_sm']} CTA(s) an SM (occupancy API); SM "
              f"clock {load['sm_mhz']:.0f} MHz and board power "
              f"{load['power_w']:.1f} W while it runs back to back "
              f"(nvidia-smi, median); SDPA launched "
              f"{', '.join(lib_kernels) or 'no kernel the profiler saw'}")
    main = per_shape[0]                  # the serving path runs float32
    return {"name": "flash_attention", "route": "cuda",
            "source": main["source"],
            "replaces": KERNELS["flash_attention"],
            "launches": sum(n["launches"]["flash_attention"]
                            for n in paths.values()),
            "launches_by_path": {arch: n["launches"]["flash_attention"]
                                 for arch, n in paths.items()},
            "max_abs_err": worst["flash_attention"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "per_shape": per_shape}


def ssd_bound(b, s, h, g, p, n, dtype) -> tuple:
    """(bound ms, "operations" or "bytes", flops, bytes) of the SSD scan at
    this shape: 4*P*N operations a (token, head), the state's update and
    read-out that every exact algorithm does, at the type's peak rate; x,
    dt, B and C read once and y and the final float32 state written once at
    the memory rate."""
    flops = ss.forward_flops(b, s, h, p, n)
    item = dtype.itemsize
    nbytes = (2 * b * s * h * p * item + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * item + b * h * p * n * 4)
    rate = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_ssd_times(serving: dict, worst: dict) -> dict:
    sc = get_arch(MAMBA_SERVE["arch"]).ssm
    b, s, h, g, p, n = (MAMBA_SERVE["batch"], MAMBA_SERVE["prompt"],
                        sc.n_heads, sc.n_groups, sc.head_dim, sc.d_state)
    rng = np.random.default_rng(4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    (built,) = _build.build(ss.SOURCE)
    per_shape = []
    for dtype in (torch.float32, torch.bfloat16):
        args = ssd_inputs(rng, b, s, h, g, p, n, dtype)
        got, state = ss.ssd_scan_cuda(*args, final_state=True)
        want, want_state = ref.ssd_chunked_ref(*args, chunk=sc.chunk)
        err = _max_err(got, want)
        check(ssd_close(got, want, dtype)
              and ssd_close(state, want_state, dtype),
              f"ssd_scan {dtype} at the main shape differs by {err}")
        worst["ssd_scan"] = max(worst["ssd_scan"], err)

        def call():
            return ss.ssd_scan_cuda(*args, final_state=True)
        ms = event_ms(call, flush)
        plain_ms = event_ms(lambda: ref.ssd_chunked_ref(*args,
                                                        chunk=sc.chunk), flush)
        bound, by, flops, nbytes = ssd_bound(b, s, h, g, p, n, dtype)
        design_flops = 2 * ss.fmas(b, s, h, g, p, n)
        kernel = "IfEEv" if dtype == torch.float32 else "I13__nv_bfloat16EEv"
        usage = {"scan": ptxas_usage(built.log, "ssd_scan_kernel" + kernel),
                 "cb": ptxas_usage(built.log, "ssd_cb_kernel" + kernel)}
        occ = ss.occupancy(dtype, p, n)
        names = device_kernels(call)
        check(len(names) == ss.DEVICE_KERNELS,
              f"one ssd_scan call launched {names}, expected "
              f"{ss.DEVICE_KERNELS} kernels")
        load = clock_under_load(call)
        per_shape.append({"dtype": str(dtype)[6:],
                          "shape": [b, s, h, g, p, n], "ms": ms,
                          "plain_ms": plain_ms, "library_ms": None,
                          "bound_ms": bound, "bound_by": by, "flops": flops,
                          "design_flops": design_flops,
                          "bytes": nbytes, "share": bound / ms,
                          "fma_rate_share": design_flops / (ms * 1e-3)
                          / F32_FLOPS,
                          "max_abs_err": err,
                          "state_max_abs_err": _max_err(state, want_state),
                          "ptxas": usage, **occ,
                          "ctas": ss.ctas(b, s, h, g, p),
                          "device_kernels": names, **load})
        print(f"  ssd_scan {str(dtype)[6:]} (B,S,H,G,P,N)=({b},{s},{h},{g},"
              f"{p},{n}), B/C strided views, y and the final state: kernel "
              f"{ms:.6f} ms, plain chunked (chunk {sc.chunk}) {plain_ms:.6f} "
              f"ms, bound {bound:.6f} ms ({by}: {flops} FLOP, {nbytes} bytes)"
              f" = {100 * bound / ms:.4f}% of the bound; max |err| {err:.3g};"
              " no single PyTorch call computes the scan (library_ms null)")
        print(f"    design: {design_flops} FLOP of float32 FMAs "
              f"({design_flops / flops:.4f}x the bound's), "
              f"{design_flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s = "
              f"{100 * design_flops / (ms * 1e-3) / F32_FLOPS:.2f}% of the "
              f"67 TFLOP/s FMA rate; {len(names)} device kernels a call: "
              f"{', '.join(names)}")
        for key, label in (("scan", "scan"), ("cb", "C B^T")):
            pre = "" if key == "scan" else "cb_"
            print(f"    {label} kernel: {usage[key]['registers']} registers a "
                  f"thread, spills {usage[key]['spill_stores']} B stored / "
                  f"{usage[key]['spill_loads']} B loaded (ptxas), "
                  f"{occ[pre + 'threads']} threads and "
                  f"{occ[pre + 'smem_bytes']} B of dynamic shared memory a "
                  f"CTA, {occ[pre + 'ctas_per_sm']} CTA(s) an SM (occupancy "
                  f"API), {ss.ctas(b, s, h, g, p)[key]} CTAs a call")
        print(f"    SM clock {load['sm_mhz']:.0f} MHz and board power "
              f"{load['power_w']:.1f} W while it runs back to back "
              "(nvidia-smi, median)")
    main = per_shape[0]                  # the serving path runs float32
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + ss.SOURCE,
            "replaces": KERNELS["ssd_scan"],
            "launches": serving["launches"]["ssd_scan"],
            "max_abs_err": worst["ssd_scan"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "per_shape": per_shape}


# the four-card run (``--cards 4``): the sharded path under NCCL, one process
# a card
CARDS = 4
CARDS_PG_TIMEOUT_S = 600   # a collective that waits longer fails its rank
CARDS_WALL_S = 900         # every rank killed past this
CARDS_GRACE_S = 30         # the others killed this long after a rank fails
RECKON_GRACE_S = 120       # the reckonings' wait once the ranks have ended
PARITY_LAYERS = 2
PARITY_ROWS = 2
PARITY_PROMPT = 8192       # past mixtral's window of 4,096: its ring wraps
PARITY_STEPS = 16
NCCL_REPS = 5
NCCL_SHAPE = (50304, 2048)  # olmo-1b's embedding table, float32


def parity_tol_steps(cfg) -> int:
    """The sharded-against-unsharded logits' tolerance, in bfloat16 steps of
    the largest |logit|: 3 sqrt(2 layers), rounded up.  The two differ only
    in each layer's two row-parallel products (attention's and the FFN's
    output projections): the sharded one rounds each rank's partial
    product to bfloat16 and sums the four in bfloat16 (four more roundings,
    each at most half a step of a partial no larger than the sum), where
    one card rounds one float32 sum once; so each adds about one step of
    its output to the hidden stream with a sign of its own, and such
    errors add as sqrt(2 layers), with the factor of the kernel-against-
    plain tolerance (``prod_logit_steps``).  The column-parallel products
    and the vocab-split head take the same sums on both."""
    return math.ceil(3 * math.sqrt(2 * cfg.n_layers))


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of ``tree``'s tensors."""
    return sum(t.to_local().numel() * t.element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def cards_checks(rank: int, out_dir: str) -> dict:
    """Step one: every check of ``mesh_checks.CHECKS`` on this rank with
    its tensors and meshes on the card, each one's numbers, wall and
    kernel launches.  A check that raises fails the rank (the others may
    wait on its collectives)."""
    out = {}
    for name, fn in mesh_checks.CHECKS.items():
        reset_launches()
        r, wall = sync_seconds(lambda: fn(rank))
        out[name] = {"result": r, "wall_s": wall, "launches": launches()}
        print(f"  check {name}: {wall:.3f} s, launches "
              f"{ {k: v for k, v in launches().items() if v} }")
        dist.barrier()
    return out


def collective_walls() -> dict:
    """NCCL's walls over the world for the collectives the sharded path
    issues, on a (50304, 2048) float32 tensor a rank (olmo-1b's embedding
    table, 412 MB): all-reduce, ``int8_all_reduce``, all-gather of a
    quarter of it a rank, reduce-scatter and all-to-all; medians of
    ``NCCL_REPS`` synchronised walls after a warm-up, with nccl-tests' bus
    rate (the bytes times 2 (n - 1) / n for an all-reduce, (n - 1) / n for
    the others, over the wall)."""
    n = dist.get_world_size()
    gen = torch.Generator(device="cuda").manual_seed(dist.get_rank())
    x = torch.randn(NCCL_SHAPE, generator=gen, device="cuda")
    nbytes = x.numel() * x.element_size()
    part = x.reshape(-1)[:x.numel() // n].clone()
    buf, out, gathered = x.clone(), torch.empty_like(part), \
        torch.empty_like(x.reshape(-1))
    ops_ = {
        "all_reduce": (lambda: dist.all_reduce(buf), 2 * (n - 1) / n),
        "int8_all_reduce": (lambda: int8_all_reduce(x), 2 * (n - 1) / n),
        "all_gather": (lambda: dist.all_gather_into_tensor(gathered, part),
                       (n - 1) / n),
        "reduce_scatter": (lambda: dist.reduce_scatter_tensor(
            out, x.reshape(-1)), (n - 1) / n),
        "all_to_all": (lambda: dist.all_to_all_single(gathered,
                                                      x.reshape(-1)),
                       (n - 1) / n)}
    res = {}
    for name, (fn, factor) in ops_.items():
        sync_seconds(fn)
        walls = [sync_seconds(fn)[1] for _ in range(NCCL_REPS)]
        ms = 1e3 * float(np.median(walls))
        res[name] = {"ms": ms, "bytes": nbytes,
                     "bus_gb_s": nbytes * factor / ms / 1e6}
        print(f"  NCCL {name} of {nbytes} B a rank over {n} cards: "
              f"{ms:.3f} ms median of {NCCL_REPS} "
              f"({res[name]['bus_gb_s']:.1f} GB/s bus rate)")
    dist.barrier()
    return res


def parity_run(params, cfg, batch, max_len: int, wrap, tokens=None) -> dict:
    """A prefill of ``batch`` into ``max_len`` positions and
    ``PARITY_STEPS`` decode steps, on greedy tokens (recorded) or on
    ``tokens``: each one's whole logits, the routes, the launches, the
    prefill's wall and peak."""
    routes = RouteRecorder()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with in_place_of(MOE, "_route", routes):
        (logits, cache), wall = sync_seconds(lambda: T.prefill(
            params, cfg, batch, max_len, dtype=torch.bfloat16))
        counts = launches()
        out = {"logits": [whole(logits)], "wall_s": wall,
               "launches": counts["flash_attention"]}
        check(counts["flash_attention"] == cfg.n_layers
              and sum(counts.values()) == cfg.n_layers,
              f"{cfg.name} parity prefill launched {counts}")
        chosen = []
        for i in range(PARITY_STEPS):
            tok = next_tokens(out["logits"][-1]) if tokens is None \
                else tokens[i]
            chosen.append(tok)
            logits, cache = T.decode_step(params, cfg, wrap(tok), cache)
            out["logits"].append(whole(logits))
    out.update(tokens=chosen, routes=routes.routes,
               peak=torch.cuda.max_memory_allocated())
    return out


def mesh_parity(arch: str, rank: int) -> dict:
    """Part 4: ``arch`` cut to ``PARITY_LAYERS`` layers at full width, its
    bfloat16 weights drawn shard by shard on the four cards and whole on
    card 0 (``shard_init``: the same values), ``PARITY_ROWS`` rows of
    ``PARITY_PROMPT`` tokens prefilled and ``PARITY_STEPS`` greedy steps
    decoded, sharded; then on card 0 unsharded, fed the sharded run's
    tokens: the prefill's and every step's logits within
    ``parity_tol_steps`` bfloat16 steps of the largest (a row whose last
    token's route changed first by a near tie, ``margin_tol``, excused and
    counted), greedy flips and MoE route changes counted."""
    free_device_memory()
    mshape = cell_memory.MESH4
    cfg = cell_memory.mesh_cfg(arch, mshape, "prefill").replace(
        n_layers=PARITY_LAYERS)
    mesh = mesh_checks.mesh_of_shape(mshape)
    msd = mesh_shape_dict(mesh)
    gen = torch.Generator(device="cuda").manual_seed(PROD_SEED)
    batch = cell_memory.prefill_inputs(cfg, PARITY_ROWS, PARITY_PROMPT,
                                       "cuda", gen)

    def wrap(t):
        return distribute_tree(t, batch_specs(cfg, t, msd), mesh)

    max_len = PARITY_PROMPT + PARITY_STEPS
    params = shard_init.init_shards(cfg, mesh, PROD_SEED, torch.bfloat16,
                                    "cuda")
    got = parity_run(params, cfg, wrap(batch), max_len, wrap)
    del params
    print(f"parity {arch}, {PARITY_LAYERS} layers at full width, "
          f"{PARITY_ROWS} x {PARITY_PROMPT} positions: sharded prefill "
          f"{got['wall_s']:.3f} s on this rank's heads, "
          f"{got['launches']} flash launches, peak {got['peak']} B")
    out = {"sharded_wall_s": got["wall_s"], "sharded_peak": got["peak"],
           "launches": got["launches"]}
    dist.barrier()
    if rank == 0:
        whole_params = shard_init.init_whole(cfg, msd, PROD_SEED,
                                             torch.bfloat16, "cuda")
        want = parity_run(whole_params, cfg, batch, max_len, lambda t: t,
                          got["tokens"])
        del whole_params
        out.update(judge_parity(arch, cfg, got, want))
    dist.barrier()
    return out


def judge_parity(arch: str, cfg, got: dict, want: dict) -> dict:
    """``mesh_parity``'s verdict on its two runs (``parity_run``'s numbers,
    sharded ``got`` and unsharded ``want``): each call's rows within
    ``parity_tol_steps``, a row past it excused where its last token's
    route changed first by a near tie; greedy flips and route changes
    counted."""
    tol = parity_tol_steps(cfg)
    moe = cfg.moe is not None
    changes = mesh_checks.route_changes(
        got["routes"], want["routes"],
        [PARITY_PROMPT] + [1] * PARITY_STEPS, cfg.n_layers if moe else 0,
        cfg.moe.top_k if moe else 1, margin_tol(parity_tol_steps, cfg))
    steps, greedy, judged = [], 0, []
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        step = bf16_step(w)
        per_row = ((g.float() - w.float()).abs().amax(-1) / step).tolist()
        # a row past the tolerance whose last token's route changed
        # first by a near tie is counted, not failed: the two runs then
        # compute another function
        judged.append(mesh_checks.judge_rows(per_row, tol, changes[i]))
        steps.append(max(per_row))
        greedy += int((g.argmax(-1) != w.argmax(-1)).sum())
        what = "prefill" if i == 0 else f"step {i}"
        check("failed" not in judged[-1], f"parity {arch} {what}: "
              f"{[round(x, 2) for x in per_row]} bfloat16 steps by row "
              f"(tol {tol}), route changes {changes[i]['rows']}")
    excused = [dict(c, call=i) for i, j in enumerate(judged)
               for c in changes[i]["rows"] if j[c["row"]] == "excused"]
    out = dict(tol_steps=tol, steps=steps, greedy_flips=greedy,
               expert_slots=sum(c["expert_slots"] for c in changes),
               keep_slots=sum(c["keep_slots"] for c in changes),
               excused_rows=len(excused), excused=excused,
               unsharded_wall_s=want["wall_s"],
               unsharded_peak=want["peak"],
               unsharded_launches=want["launches"])
    print(f"  against the unsharded model on card 0 (prefill "
          f"{want['wall_s']:.3f} s, {want['launches']} flash launches, "
          f"fed the sharded run's tokens): prefill logits "
          f"{steps[0]:.2f} bfloat16 steps of the largest, decode steps "
          f"up to {max(steps[1:]):.2f} (tol {tol}); {greedy} greedy "
          f"flips in {PARITY_ROWS * (PARITY_STEPS + 1)}; MoE (token, "
          f"slot)s whose expert differs {out['expert_slots']}, whose "
          f"capacity keep alone differs {out['keep_slots']}; "
          f"{len(excused)} of the {PARITY_ROWS * (PARITY_STEPS + 1)} "
          f"rows past the tolerance, each with its last token's route "
          f"changed first by a near tie (counted, not failed): "
          f"{out['excused']}")
    return out


def mesh_cells(arch: str, rank: int) -> dict:
    """Step two: ``arch``'s prefill_32k and decode_32k in bfloat16 on
    (data 1, model 4) at full width and depth, ``cell_memory.MESH4_ROWS``
    rows, ``build_cfg``'s tp-4 config, its weights drawn shard by shard
    (``shard_init``); on each rank ``production_cells``' checks of its own
    heads: one bfloat16 flash launch a layer in a prefill and none in
    decode, layers 0 and last on rows 0 and B-1 and then every layer's
    call on one row against the plain version, the logits of the prefill
    and of the first decode step against the same sharded model with
    plain attention, the kernel timed at the rank's local shape, walls
    and the peak."""
    free_device_memory()
    mshape = cell_memory.MESH4
    cfg = cell_memory.mesh_cfg(arch, mshape, "prefill")
    mesh = mesh_checks.mesh_of_shape(mshape)
    msd = mesh_shape_dict(mesh)
    kernel, target, staged, source = kernel_entry(cfg)
    rows, n_layers = cell_memory.MESH4_ROWS[arch], cfg.n_layers
    s = SHAPES["prefill_32k"].seq_len
    steps = cell_memory.DECODE_STEPS
    gen = torch.Generator(device="cuda").manual_seed(PROD_SEED)

    def wrap(t):
        return distribute_tree(t, batch_specs(cfg, t, msd), mesh)

    params, init_s = sync_seconds(lambda: shard_init.init_shards(
        cfg, mesh, PROD_SEED, torch.bfloat16, "cuda"))
    batch = wrap(cell_memory.prefill_inputs(cfg, rows, s, "cuda", gen))
    dims = T._dims(cfg)
    print(f"production cells on {mshape}: {arch} ({n_layers} layers, "
          f"d_model {cfg.d_model}, {dims.n_q_phys}/{dims.n_kv_phys} q/kv "
          f"heads, {dims.n_q_phys // cfg.tp}/{dims.n_kv_phys // cfg.tp} on "
          f"this rank, window {cfg.swa_window}, int8 KV cache "
          f"{cfg.kv_quant}, vocab {cfg.vocab}), {int(cfg.param_count())} "
          f"bfloat16 parameters, {local_bytes(params)} B on this rank "
          f"(drawn shard by shard, seed {PROD_SEED}, {init_s:.3f} s), "
          f"{rows} rows (launch/cell_memory.py MESH4_ROWS)")
    out = {"rows": rows, "kernel": kernel, "weights_bytes":
           local_bytes(params)}

    # (a) prefill_32k
    rec = RowRecorder(target[2], (0, n_layers - 1), (0, rows - 1), staged)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with in_place_of(target[0], target[1], rec):
        (logits, cache), wall = sync_seconds(lambda: T.prefill(
            params, cfg, batch, s, dtype=torch.bfloat16))
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(counts[kernel] == n_layers and sum(counts.values()) == n_layers,
          f"{arch} prefill_32k launched {counts} on rank {rank}")
    check(rec.n == n_layers, f"{arch}: {rec.n} {kernel} calls")
    full = whole(logits)
    check(full.dtype == torch.bfloat16 and tuple(full.shape)
          == (rows, cfg.vocab) and bool(torch.isfinite(full).all()),
          f"{arch} prefill logits {full.dtype} {tuple(full.shape)}")
    want_leaves = flatten(T.cache_leaf_shapes(cfg, rows, s,
                                              torch.bfloat16)["blocks"])
    got_leaves = flatten(cache["blocks"])
    check(cache["pos"] == s and all(
        tuple(got_leaves[k].shape) == w.shape and got_leaves[k].dtype
        == w.dtype for k, w in want_leaves.items()),
        f"{arch}: the cache is not the bfloat16 cache of {s} positions")
    cache_b = local_bytes(got_leaves)
    check(peak < CARD_BYTES, f"{arch} prefill_32k peak {peak} B")
    print(f"  prefill_32k: {rows} x {s} positions in {wall:.6f} s "
          f"({rows * s / wall:.1f} tokens/s), {counts[kernel]} {kernel} "
          f"launches on this rank ({source}); its cache shards {cache_b} B;"
          f" peak {peak} B ({rec.held_bytes()} B of it the recorded rows)")
    out["prefill"] = {"wall_s": wall, "tokens_per_s": rows * s / wall,
                      "peak_bytes": peak, "launches": counts[kernel],
                      "cache_bytes": cache_b}
    del cache, got_leaves
    out["layer_err"] = check_layers(kernel, rec, (0, rows - 1))
    del rec
    got_a = full[:PROD_CHECK_ROWS].clone()
    del logits, full

    # (b) decode_32k
    short = {k: v[:, :v.shape[1] - steps] for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (logits, cache), wall_b = sync_seconds(lambda: T.prefill(
        params, cfg, short, s, dtype=torch.bfloat16))
    counts = launches()
    check(counts[kernel] == n_layers and sum(counts.values()) == n_layers,
          f"{arch} decode_32k prefill launched {counts} on rank {rank}")
    first_tok = wrap(next_tokens(whole(logits)))
    del logits
    got_b, walls, busy_s, cache = decode_run(
        params, cfg, first_tok, cache, steps, f"{arch} decode_32k", wrap)
    peak_b = torch.cuda.max_memory_allocated()
    check(cache["pos"] == s, f"{arch}: decode ended at {cache['pos']}")
    check(peak_b < CARD_BYTES, f"{arch} decode_32k peak {peak_b} B")
    step_ms = 1e3 * float(np.median(walls))
    print(f"  decode_32k: prefill of {rows} x {s - steps} positions in "
          f"{wall_b:.6f} s, then {steps} greedy steps up to position "
          f"{s - 1}: no launch; a step {step_ms:.3f} ms median (untraced "
          f"steps {[round(1e3 * w, 3) for w in walls]} ms), "
          f"{rows / step_ms * 1e3:.1f} tokens/s; peak {peak_b} B")
    out["decode"] = {"prefill_wall_s": wall_b, "launches": counts[kernel],
                     "step_ms": step_ms,
                     "step_ms_all": [1e3 * w for w in walls],
                     "tokens_per_s": rows / step_ms * 1e3,
                     "peak_bytes": peak_b, "traced_busy_s": busy_s}
    del cache
    out.update(plain_checks(params, cfg, batch, got_a, got_b,
                            first_tok[:PROD_CHECK_ROWS], target,
                            moe_routes=True))
    out["times"] = prod_kernel_times(cfg, rows, s, kernel, gen,
                                     shards=cfg.tp)
    del params, batch, short
    dist.barrier()
    return out


# the four-card train cells' 2-layer parity (``mesh_train``): its steps
TRAIN_PARITY_STEPS = 2
# a train cell's loss before its first update, against ``loss_at_init``:
# within this many nats (4-card call 2, PR 34: yi-6b 11.811 against
# 11.887, musicgen-large 8.027 against 8.034); a loss summed over the tp
# ranks, padding counted in its mean or a codebook left out moves it by
# more than a nat
TRAIN_LOSS0_BAND = 0.25


def loss_at_init(cfg) -> float:
    """The cross-entropy a train cell starts from: the lm_head's init
    (``common.init_scale('lm_head')``, sigma) makes each logit a Gaussian of
    variance d_model sigma^2 over the final norm's output (RMS 1) and
    independent of the label, so the mean of log-sum-exp over the vocab
    less the label's logit is ln(vocab) + d_model sigma^2 / 2."""
    sigma = init_scale("lm_head")
    return math.log(cfg.vocab) + cfg.d_model * sigma ** 2 / 2


def nccl_share(fn, label: str) -> tuple:
    """(``fn()``, its numbers) of one call of ``fn`` (a train step) traced by
    torch.profiler on this rank, its device activity alone: its wall, its
    kernels' device seconds and the NCCL kernels' among them, summed over
    the profiler's raw events (its tables, ``key_averages``, make a Python
    object of each of a step's million events: minutes for musicgen-large's
    step, past the run's limit, in 4-card call 2, PR 34)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, traced_s = sync_seconds(fn)
    busy_ns = nccl_ns = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            if "nccl" in e.name().lower():
                nccl_ns += e.duration_ns()
    busy_s, nccl_s = 1e-9 * busy_ns, 1e-9 * nccl_ns
    print(f"  {label}: one step traced on this rank, {traced_s:.6f} s: "
          f"device kernels {busy_s:.6f} s ({100 * busy_s / traced_s:.2f}% "
          f"of the traced step), NCCL kernels {nccl_s:.6f} s = "
          f"{100 * nccl_s / traced_s:.2f}% of it"
          + (f", {100 * nccl_s / busy_s:.2f}% of the device time"
             if busy_s > 0 else "; no device time recorded"))
    return out, {"traced_s": traced_s, "busy_s": busy_s, "nccl_s": nccl_s}


def mesh_train(arch: str, rank: int) -> dict:
    """Step three: ``arch``'s train_4k step in bfloat16 on its mesh of
    ``cell_memory.MESH4_TRAIN`` at full width and depth, at that table's
    rows: the reference's config (``build_cfg``'s, attention through the
    chunked schedule with remat, ``make_train_step(cfg, AdamWConfig(
    moment_dtype=cfg.opt_dtype), num_microbatches=TRAIN_MICROBATCHES[arch]
    )``), weights drawn shard by shard, ZeRO-1 moments at ``opt_dtype``
    made on their shards, the packed batch laid out by ``batch_specs``.
    Three steps on the one batch: step 0 under ``CollectiveCounter`` (its
    collectives; the counter slows it), step 1 timed and split into its
    microbatches and its update (``StepSplit``), step 2 traced on rank 0
    (the NCCL kernels' share); after each, its loss and grad norm, every
    leaf's placements, the kernel launches (none: attention trains through
    ``chunked``) and the peak; then the leaf dtypes, and the 2-layer parity
    (``mesh_checks.train_parity``: the same arch cut to 2 layers on the
    same shard-drawn weights, its steps sharded against card 0's
    unsharded).  ``judge_cards`` holds the ranks' numbers together, and
    against the reckoning and the dry run's collectives."""
    from repro_torch.launch.commcount import CollectiveCounter
    free_device_memory()
    mshape, rows = cell_memory.MESH4_TRAIN[arch]
    cell = SHAPES["train_4k"]
    seq, m = cell.seq_len, TRAIN_MICROBATCHES[arch]
    cfg = cell_memory.mesh_cfg(arch, mshape, "train")
    check(cfg.attn_impl_train == "chunked" and cfg.remat,
          f"{arch} does not train as the reference's config does")
    mesh = mesh_checks.mesh_of_shape(mshape)
    msd = mesh_shape_dict(mesh)
    tokens = rows * seq
    flops = T.model_flops(cfg, tokens, seq)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype)

    def init():
        p = shard_init.init_shards(cfg, mesh, PROD_SEED, torch.bfloat16,
                                   "cuda")
        return p, shard_init.zero1_state(cfg, p, mesh, opt_cfg)
    (params, opt), init_s = sync_seconds(init)
    label = f"{arch} train_4k on {mshape}"
    check_train_dtypes(params, opt, cfg, 0, f"{label} at init")
    plain = packed_batch(cfg, rows, seq)
    batch = distribute_tree(plain, batch_specs(cfg, plain, msd), mesh)
    tok = plain["tokens"]
    nonpad = int((tok[..., 0] if cfg.n_codebooks else tok).ne(0).sum())
    layout = mesh_checks.train_layout(params, opt)
    step = make_train_step(cfg, opt_cfg, num_microbatches=m)
    print(f"train_4k on {mshape}: {arch} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, tp {cfg.tp}, batch over "
          f"{cfg.batch_axes}, remat, attention {cfg.attn_impl_train}), "
          f"{int(cfg.param_count())} bfloat16 parameters drawn shard by "
          f"shard (seed {PROD_SEED}, {init_s:.3f} s): {local_bytes(params)}"
          f" B of weights and {local_bytes(opt)} B of {cfg.opt_dtype} "
          f"moments (ZeRO-1 over {shard_init.zero1_axes(cfg)}) on this "
          f"rank; {rows} rows of the cell's {cell.global_batch} x {seq} "
          f"tokens (launch/cell_memory.py MESH4_TRAIN), {nonpad} of "
          f"{tokens} not padding, "
          f"{batch['tokens'].to_local().shape[0]} rows on this rank, {m} "
          "microbatches (TRAIN_MICROBATCHES); step 0 counted, step 1 "
          "timed, step 2 traced")
    losses, gnorms, walls, peaks, counts, kept = [], [], [], [], [], []
    colls = nccl = None
    micro, update_s = [], None
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        if i == 0:
            with CollectiveCounter() as counter:
                (params, opt, metrics), wall = sync_seconds(
                    lambda: step(params, opt, batch))
            colls = counter.result()
        elif i == 1:
            with StepSplit() as split:
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            check(len(split.marks) == m + 1, f"{label}: step 1 entered "
                  f"loss_fn and the clip {len(split.marks)} times, "
                  f"expected {m + 1}")
            micro = [b - a for a, b in zip(split.marks, split.marks[1:])]
            update_s = t0 + wall - split.marks[-1]
        elif rank == 0:
            (params, opt, metrics), nccl = nccl_share(
                lambda: step(params, opt, batch), label)
            wall = nccl["traced_s"]
        else:
            (params, opt, metrics), wall = sync_seconds(
                lambda: step(params, opt, batch))
        counts.append(launches())
        peaks.append(torch.cuda.max_memory_allocated())
        walls.append(wall)
        losses.append(float(whole(metrics["loss"])))
        gnorms.append(float(whole(metrics["grad_norm"])))
        kept.append(mesh_checks.train_layout(params, opt) == layout)
        check(kept[-1], f"{label} step {i}: a weight or moment left the "
              "layout param_specs and zero1_specs gave it")
        print(f"    step {i} ({('counted', 'timed', 'traced')[i]}): loss "
              f"{losses[-1]:.6f}, grad norm {gnorms[-1]:.6f}, wall "
              f"{wall:.6f} s"
              + (f" = {m} microbatches " + " + ".join(
                  f"{t:.6f}" for t in micro) + f" s + update {update_s:.6f}"
                 " s" if i == 1 else "")
              + f"; peak {peaks[-1] / 1e9:.3f} GB; launches "
              f"{json.dumps(counts[-1])}")
    check(all(map(math.isfinite, losses + gnorms))
          and abs(losses[0] - loss_at_init(cfg)) <= TRAIN_LOSS0_BAND,
          f"{label}: losses {losses}, grad norms {gnorms}: not finite, or "
          f"the first not within {TRAIN_LOSS0_BAND} of the init's "
          f"{loss_at_init(cfg):.6f}")
    check(not any(v for c in counts for v in c.values()),
          f"{label}: launches {counts}: attention trains through chunked")
    check_train_dtypes(params, opt, cfg, len(losses), label)
    print(f"  {label}: step 0's collectives on this rank "
          f"{json.dumps(colls['counts'])}, result bytes "
          f"{json.dumps(colls['looped'])}")
    wall = walls[1]
    micro_s = statistics.median(micro)
    out = {"mesh": mshape, "rows": rows, "microbatches": m,
           "tokens": tokens, "nonpad": nonpad, "losses": losses,
           "grad_norms": gnorms, "loss_init": loss_at_init(cfg),
           "walls": walls, "wall_s": wall,
           "tokens_per_s": tokens / wall, "model_tflops": flops / wall / 1e12,
           "peaks": peaks, "launches_per_step": counts, "kept_layout": kept,
           "microbatch_walls": micro, "update_s": update_s,
           "microbatch_s": micro_s, "weights_bytes": local_bytes(params),
           "opt_bytes": local_bytes(opt), "collectives": colls,
           "nccl": nccl}
    print(f"  {label}: step 1's wall {wall:.6f} s, {tokens / wall:.1f} "
          f"tokens/s and {flops / wall / 1e12:.3f} model TFLOP/s on the "
          f"mesh; median microbatch {micro_s:.6f} s (x {m} = "
          f"{m * micro_s:.6f} s), update {update_s:.6f} s; peaks "
          + ", ".join(f"{p / 1e9:.3f}" for p in peaks) + " GB")
    del params, opt, batch, metrics
    free_device_memory()
    cfg2 = cfg.replace(n_layers=PARITY_LAYERS)
    par, par_s = sync_seconds(lambda: mesh_checks.train_parity(
        cfg2, mesh, plain, steps=TRAIN_PARITY_STEPS,
        microbatches=m, seed=PROD_SEED, unsharded_on=0))
    out.update(parity=par, parity_s=par_s)
    print(f"  {arch} 2-layer train parity ({TRAIN_PARITY_STEPS} "
          f"steps, {par_s:.3f} s): " + train_parity_line(par))
    dist.barrier()
    return out


def train_parity_line(r: dict) -> str:
    """``mesh_checks.train_parity``'s numbers against
    ``mesh_checks.BF16_STEP_TOL``, in words."""
    if "weights" not in r:
        return (f"sharded losses {r['loss']}, layouts kept "
                f"{r['kept_layout']} (compared on card 0)")
    tol, lr, steps = mesh_checks.BF16_STEP_TOL, r["lr"], len(r["loss"])
    rel = [[abs(a - b) / abs(b) for a, b in r[k]] for k in ("loss",
                                                             "grad_norm")]
    w = r["weights"]
    worst = max(w["leaves"].items(), key=lambda kv: kv[1][0] - kv[1][1])
    l2 = {k: max(math.sqrt(v[i] / v[i + 1]) if v[i + 1] else 0.0
                 for v in r["moments"].values())
          for k, i in (("m", 4), ("v", 6))}
    return (f"loss relative {[f'{x:.3g}' for x in rel[0]]} (tol "
            f"{tol['loss']}, then {tol['loss_own']}), grad norm "
            f"{[f'{x:.3g}' for x in rel[1]]} (tol {tol['grad_norm']} x "
            f"{r['layers']} layers); weights: worst leaf {worst[0]} "
            f"{worst[1][0] / lr:.3f} lr (tol {tol['lr_a_step'] * steps} lr"
            f" + its bfloat16 step {worst[1][1] / lr:.3f} lr); "
            f"{w['past']} of {w['total']} weights "
            f"({100 * w['past'] / w['total']:.4f}%) past 0.5 lr plus a "
            f"step of their own value (tol "
            f"{100 * tol['flips'] * steps:.2f}%); moments' worst leaf "
            f"relative L2 m {l2['m']:.4f}, v {l2['v']:.4f} (tol {tol['m']}, "
            f"{tol['v']}); update {r['update'] / lr:.3f} lr; layouts kept "
            f"{r['kept_layout']}; held: {mesh_checks._bf16_step_ok(r)}")


CARDS_PHASES = ("checks", "nccl", "parity", "cells", "train")


def cards_rank(rank: int, store: str, out_dir: str,
               phases: tuple = CARDS_PHASES) -> None:
    """One rank of the four-card run, a spawned process on card ``rank``:
    its process group (a FileStore at ``store``), then of ``phases`` in
    their order step one, NCCL's walls, the parity runs, the 32k cells and
    the train cells; its log ``rank<r>.log`` and numbers ``rank<r>.json``
    in ``out_dir``.  Exits 0 when it raised nothing (its failed checks are
    in the numbers)."""
    global FAILED
    FAILED = []
    sys.stdout = open(os.path.join(out_dir, f"rank{rank}.log"), "w",
                      buffering=1)
    res: dict = {"rank": rank}
    code = 1
    try:
        torch.manual_seed(0)
        torch.cuda.set_device(rank)
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "nccl", store=dist.FileStore(store, CARDS), rank=rank,
            world_size=CARDS,
            timeout=datetime.timedelta(seconds=CARDS_PG_TIMEOUT_S),
            device_id=torch.device("cuda", rank))
        res["card"] = torch.cuda.get_device_name(rank)
        mesh_checks.DEVICE, mesh_checks.OUT_DIR = "cuda", out_dir
        run = {"checks": lambda: cards_checks(rank, out_dir),
               "nccl": collective_walls,
               "parity": lambda: {a: mesh_parity(a, rank)
                                  for a in cell_memory.MESH4_ROWS},
               "cells": lambda: {a: mesh_cells(a, rank)
                                 for a in cell_memory.MESH4_ROWS},
               "train": lambda: {a: mesh_train(a, rank)
                                 for a in cell_memory.MESH4_TRAIN}}
        for name in phases:
            t0 = time.perf_counter()
            res[name] = run[name]()
            res.setdefault("walls", {})[name] = time.perf_counter() - t0
            print(f"phase {name}: {res['walls'][name]:.3f} s")
            # what a rank killed at CARDS_WALL_S leaves to read
            with open(os.path.join(out_dir, f"rank{rank}.partial.json"),
                      "w") as f:
                json.dump(dict(res, failed=FAILED), f, default=str)
        dist.barrier()
        code = 0
    except Exception:
        res["error"] = traceback.format_exc()
        print(res["error"])
    finally:
        res["failed"] = FAILED
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f, default=str)
        sys.stdout.flush()
    # no teardown of the NCCL communicators: destroying them once hung the
    # ranks for minutes after every result was written; the process's end
    # frees them
    os._exit(code)


def wait_ranks(procs: list, out_dir: str) -> list:
    """The ranks' exit codes once all have ended; a rank still running
    ``CARDS_GRACE_S`` after another failed or after every rank wrote its
    numbers, or at ``CARDS_WALL_S``, is killed (None)."""
    deadline = time.monotonic() + CARDS_WALL_S
    failed_at = None
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if failed_at is None and (
                any(p.exitcode not in (None, 0) for p in procs)
                or all(os.path.exists(os.path.join(out_dir, f"rank{r}.json"))
                       for r in range(len(procs)))):
            failed_at = time.monotonic()
        if failed_at is not None and \
                time.monotonic() - failed_at > CARDS_GRACE_S:
            break
        time.sleep(1.0)
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
        codes.append(p.exitcode if p.exitcode in (0, 1) else None)
    return codes


def reckon_to(path: str, arch: str, names: tuple) -> None:
    """``reckon_cells(arch, names)`` in a process of its own, its numbers
    to ``path``."""
    with open(path, "w") as f:
        json.dump(reckon_cells(arch, names), f)


def reckon_cells(arch: str, names: tuple) -> dict:
    """``cell_memory.reckon`` of ``arch``'s four-card cells ``names`` for a
    device of their mesh (the 32k cells' ``MESH4`` at ``MESH4_ROWS``, the
    train cell's mesh and rows of ``MESH4_TRAIN``), on meta tensors over a
    fake process group (host work); a train cell's also holds the dry
    run's count of its step's collectives."""
    out = {}
    for name in names:
        cell = SHAPES[name]
        mshape, rows = cell_memory.MESH4_TRAIN[arch] \
            if cell.kind == "train" else (cell_memory.MESH4,
                                          cell_memory.MESH4_ROWS[arch])
        with cell_memory.fake_mesh(mshape) as mesh:
            cfg = cell_memory.mesh_cfg(arch, mshape, cell.kind)
            out[f"{arch} {name}"] = cell_memory.reckon(cfg, cell, rows, mesh)
    return out


def reckonings(phases: tuple) -> list:
    """(arch, cell names) of the reckonings ``phases`` are judged by, one
    process each."""
    out = []
    if "cells" in phases:
        out += [(a, ("prefill_32k", "decode_32k"))
                for a in cell_memory.MESH4_ROWS]
    if "train" in phases:
        out += [(a, ("train_4k",)) for a in cell_memory.MESH4_TRAIN]
    return out


def judge_cards(results: list, reckoned: dict) -> list:
    """Every rank's numbers held: no failed check, step one within its
    tests' tolerances (``mesh_checks.verdicts``), the launch counts, each
    32k cell's peaks under the card's bytes, printed beside the reckoning,
    and the train cells (``judge_train``); everything is printed before the
    first failure raises.  Returns the kernels' lines: the flash kernel's,
    when the 32k cells ran."""
    bad = {}
    if "checks" in results[0]:
        names = list(mesh_checks.CHECKS)
        verdict = mesh_checks.verdicts({n: [res["checks"][n]["result"]
                                            for res in results]
                                        for n in names})
        for n in names:
            walls = [res["checks"][n]["wall_s"] for res in results]
            print(f"step one, {n}: "
                  f"{'held' if verdict[n] is None else 'FAILED'} on all "
                  f"{len(results)} ranks (walls {min(walls):.3f}-"
                  f"{max(walls):.3f} s)")
        bad = {n: v for n, v in verdict.items() if v is not None}
    by_path, errs, per_shape = {}, [], []
    for arch in cell_memory.MESH4_ROWS if "parity" in results[0] else ():
        par = results[0]["parity"][arch]
        print(f"parity {arch}: prefill {par['steps'][0]:.2f} steps, decode "
              f"up to {max(par['steps'][1:]):.2f} (tol {par['tol_steps']});"
              f" greedy flips {par['greedy_flips']}; MoE slots whose expert "
              f"differs {par['expert_slots']}, whose keep alone differs "
              f"{par['keep_slots']}; rows past the tolerance whose route "
              f"changed first by a near tie {par['excused_rows']}")
        by_path[f"{arch} parity, {PARITY_LAYERS} layers, sharded"] = sum(
            res["parity"][arch]["launches"] for res in results)
        by_path[f"{arch} parity, unsharded on card 0"] = \
            par["unsharded_launches"]
    for arch in cell_memory.MESH4_ROWS if "cells" in results[0] else ():
        for name in ("prefill", "decode"):
            cell = f"{arch} {name}_32k"
            want = reckoned.get(cell)
            peaks = [res["cells"][arch][name]["peak_bytes"]
                     for res in results]
            print(f"{cell} bfloat16 on {cell_memory.MESH4}: peaks "
                  f"{peaks} B against " + (
                      f"the reckoned {want['total']} B a device (weights "
                      f"{want['params']}, cache {want['cache']}, peak "
                      f"{want['peak']})" if want else "no reckoning (its "
                      "process did not finish)"))
            by_path[f"{cell} bfloat16, 4 cards"] = sum(
                res["cells"][arch][name]["launches"] for res in results)
        for res in results:
            c = res["cells"][arch]
            errs += [*c["layer_err"].values(), *c["every_layer_err"]]
        per_shape.append(results[0]["cells"][arch]["times"])
    if "train" in results[0]:
        judge_train(results, reckoned)
    for r, res in enumerate(results):
        check(not res["failed"], f"rank {r}: {len(res['failed'])} failed "
              f"checks: {res['failed'][:5]}")
    check(not bad, f"step one outside its tests' tolerances: "
          f"{json.dumps(bad)[:2000]}")
    if not per_shape:
        return []
    lib = [t["library_ms"] for t in per_shape]
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/"
             + fa.route(torch.bfloat16),
             "replaces": KERNELS["flash_attention"],
             "launches": sum(by_path.values()),
             "launches_by_path": by_path, "max_abs_err": max(errs),
             "ms": sum(t["ms"] for t in per_shape), "plain_ms": None,
             "bound_ms": sum(t["bound_ms"] for t in per_shape),
             "bound_by": per_shape[0]["bound_by"],
             "library_ms": None if None in lib else sum(lib),
             "per_shape": per_shape}
    if "checks" in results[0]:
        entry["launches_in_step_one"] = {
            n: {k: sum(res["checks"][n]["launches"][k] for res in results)
                for k in launches()} for n in mesh_checks.CHECKS}
    return [entry]


def judge_train(results: list, reckoned: dict) -> None:
    """The train cells (``mesh_train``) of every rank: losses and grad
    norms finite and equal on every rank, the first loss within
    ``TRAIN_LOSS0_BAND`` of ``loss_at_init``, a step among them lowering
    the loss, and a loss that AdamW's first update raises raised by it in
    card 0's unsharded 2-layer steps on the same weights, batch and lr too
    (the parity's: the rise is the step's own at the reference's lr, not
    the sharding's), no kernel launched in any step, every leaf in its layout after each step, each
    step's peak under the card's bytes and those of steps 1-2 within
    ``TRAIN_4K_PEAK_MARGIN`` of the reckoning for a device of the mesh,
    each rank's collectives of step 0 equal by kind, count and bytes to
    the dry run's for the same cell on a fake mesh of that shape (the
    reckoning's), and the 2-layer parity within
    ``mesh_checks.BF16_STEP_TOL`` (card 0's comparison, every rank's
    layouts and losses)."""
    for arch in cell_memory.MESH4_TRAIN:
        t0 = results[0]["train"][arch]
        want = reckoned.get(f"{arch} train_4k")
        label = f"{arch} train_4k on {t0['mesh']}"
        nccl = t0["nccl"]
        print(f"{label}, {t0['rows']} rows x 4096 tokens, "
              f"{t0['microbatches']} microbatches: losses "
              f"{[round(x, 6) for x in t0['losses']]}; step walls "
              f"{[round(x, 6) for x in t0['walls']]} s (counted, timed, "
              f"traced); the timed step {t0['wall_s']:.6f} s, "
              f"{t0['tokens_per_s']:.1f} tokens/s and "
              f"{t0['model_tflops']:.3f} model TFLOP/s on the mesh, its "
              f"median microbatch {t0['microbatch_s']:.6f} s, its update "
              f"{t0['update_s']:.6f} s; rank 0's traced step: NCCL kernels "
              + (f"{nccl['nccl_s']:.6f} s of its {nccl['traced_s']:.6f} s "
                 f"({100 * nccl['nccl_s'] / nccl['traced_s']:.2f}%), every "
                 f"kernel {nccl['busy_s']:.6f} s" if nccl
                 else "not measured"))
        for r, res in enumerate(results):
            t = res["train"][arch]
            peak = max(t["peaks"][1:])
            print(f"  rank {r}: peaks {[round(p / 1e9, 3) for p in t['peaks']]}"
                  f" GB against " + (
                      f"the reckoned {want['total'] / 1e9:.3f} GB a device "
                      f"(weights {want['params'] / 1e9:.3f}, moments "
                      f"{want['opt'] / 1e9:.3f}, made {want['peak'] / 1e9:.3f})"
                      if want else "no reckoning (its process did not "
                      "finish)") + f"; collectives {t['collectives']['counts']}"
                  f", bytes {t['collectives']['looped']['total']}")
            check(all(map(math.isfinite, t["losses"] + t["grad_norms"]))
                  and t["losses"] == t0["losses"]
                  and t["grad_norms"] == t0["grad_norms"],
                  f"rank {r}: {label} losses {t['losses']}, grad norms "
                  f"{t['grad_norms']} (rank 0: {t0['losses']}, "
                  f"{t0['grad_norms']})")
            check(all(t["kept_layout"]) and t["parity"]["kept_layout"],
                  f"rank {r}: {label} moved a leaf's layout")
            check(t["launches_per_step"] and all(
                c and not any(c.values()) for c in t["launches_per_step"]),
                f"rank {r}: {label} launched {t['launches_per_step']}")
            check(max(t["peaks"]) < CARD_BYTES,
                  f"rank {r}: {label} peak {max(t['peaks'])} B")
            check(want is not None and abs(peak - want["total"])
                  <= TRAIN_4K_PEAK_MARGIN, f"rank {r}: {label} peak {peak}"
                  f" B against the reckoned {want and want['total']} B")
            got_c = {k: t["collectives"][k] for k in ("counts", "looped")}
            check(want is not None and got_c == {
                k: want["collectives"][k] for k in ("counts", "looped")},
                f"rank {r}: {label} collectives {got_c} against the dry "
                f"run's {want and want['collectives']}")
            check([x[0] for x in t["parity"]["loss"]]
                  == [x[0] for x in t0["parity"]["loss"]],
                  f"rank {r}: {arch} parity losses differ from rank 0's")
        losses, init = t0["losses"], t0["loss_init"]
        # card 0's unsharded 2-layer losses, before and after one update
        witness = [x[-1] for x in t0["parity"]["loss"]]
        print(f"  {label}: first loss {losses[0]:.6f} against the init's "
              f"{init:.6f} (band {TRAIN_LOSS0_BAND}); after AdamW's first "
              f"update {losses[0]:.6f} -> {losses[1]:.6f}, card 0's "
              f"unsharded 2-layer steps {witness[0]:.6f} -> "
              f"{witness[1]:.6f}")
        check(abs(losses[0] - init) <= TRAIN_LOSS0_BAND,
              f"{label}: first loss {losses[0]} against {init}")
        check(any(b < a for a, b in zip(losses, losses[1:])),
              f"{label}: losses {losses}: no step lowered the loss")
        check(losses[1] <= losses[0] or witness[1] > witness[0],
              f"{label}: the first update raised the loss ({losses[:2]}) "
              f"but not card 0's unsharded 2-layer loss ({witness})")
        print(f"  {arch} 2-layer train parity, sharded against card 0 "
              f"unsharded: {train_parity_line(t0['parity'])}")
        check(mesh_checks._bf16_step_ok(t0["parity"]),
              f"{arch} 2-layer train parity outside "
              f"{mesh_checks.BF16_STEP_TOL}")


def main_cards(n: int, log_dir: str | None,
               phases: tuple = CARDS_PHASES) -> int:
    """``--cards n``: the four-card run of ``phases`` (see the module
    docstring)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    seen = torch.cuda.device_count()
    if n != CARDS or seen != n:
        print(f"chip_smoke: --cards {n} runs on {CARDS} cards; torch sees "
              f"{seen}", file=sys.stderr)
        return 1
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    kind, _ = phase_card()
    phase_build()
    smi = nvidia_smi(every=True)
    print(f"cards: {smi}")
    out_dir = log_dir or tempfile.mkdtemp(prefix="chip_smoke_cards_")
    os.makedirs(out_dir, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=cards_rank, args=(
        r, os.path.join(store_dir, "store"), out_dir, phases))
        for r in range(n)]
    for p in procs:
        p.start()
    # host work beside the ranks, a process for each arch's cells
    paths = [os.path.join(out_dir, f"reckoned_{i}.json")
             for i, _ in enumerate(reckonings(phases))]
    reckoners = [ctx.Process(target=reckon_to, args=(path, *job))
                 for path, job in zip(paths, reckonings(phases))]
    for p in reckoners:
        p.start()
    try:
        codes = wait_ranks(procs, out_dir)
    finally:
        until = time.monotonic() + RECKON_GRACE_S
        for p in reckoners:
            p.join(timeout=max(1.0, until - time.monotonic()))
            if p.is_alive():
                p.kill()
        shutil.rmtree(store_dir, ignore_errors=True)
    reckoned = {}
    for path in paths:
        if os.path.exists(path):
            reckoned.update(json.load(open(path)))
    results = []
    for r in range(n):
        path = os.path.join(out_dir, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else {"error": "no results"})
    log0 = os.path.join(out_dir, "rank0.log")
    if os.path.exists(log0):
        print(open(log0).read(), end="")
    for r, res in enumerate(results):
        if "error" in res:
            print(f"rank {r}: {res['error']}")
    check(all(c == 0 for c in codes) and not any("error" in res
                                                 for res in results),
          f"ranks ended with {codes} (None: killed); logs in {out_dir}")
    entries = judge_cards(results, reckoned)
    walls = results[0].get("walls", {})
    print("phase walls (rank 0): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()))
    print(f"total wall: {time.perf_counter() - t0:.3f} s; logs in "
          f"{out_dir}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": n}}))
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port's main "
                                 "paths on CUDA cards and check them.")
    ap.add_argument("--cards", type=int, default=1,
                    help="1 (every phase on one card) or 4 (the sharded "
                    "path on four cards under NCCL)")
    ap.add_argument("--log-dir", default=None,
                    help="with --cards 4: where each rank's log and "
                    "numbers go (default: a temporary directory)")
    ap.add_argument("--phases", default=",".join(CARDS_PHASES),
                    help="with --cards 4: the phases to run, in their order"
                    f", of {','.join(CARDS_PHASES)} (default: all)")
    args = ap.parse_args(argv)
    phases = tuple(p for p in CARDS_PHASES if p in args.phases.split(","))
    if set(args.phases.split(",")) - set(CARDS_PHASES) or not phases:
        ap.error(f"--phases takes names of {CARDS_PHASES}")
    if args.cards != 1:
        return main_cards(args.cards, args.log_dir, phases)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS under deterministic algorithms (phase_training) needs a fixed
    # workspace, set before the CUDA context is made
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    walls: dict = {}

    def run(fn, *args, **kw):
        """``fn(*args, **kw)``, its wall added to ``walls[fn.__name__]``."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[fn.__name__] = walls.get(fn.__name__, 0.0) \
            + time.perf_counter() - t
        return out

    kind, smi = run(phase_card)
    run(phase_build)
    worst = run(phase_parity)
    run(phase_flash_parity, worst)
    run(phase_ssd_parity, worst)
    run(phase_zero_rows)
    main_path = run(phase_main_path)
    run(phase_runtime, main_path)
    run(phase_small_path)
    run(phase_apps)
    serving = run(phase_serving)
    run(phase_int8_serving, serving)
    run(phase_serving_cpu, "olmo-1b", {"flash_attention"},
        attn_impl_train="pallas")
    mamba = run(phase_mamba_serving)
    run(phase_serving_cpu, "mamba2-1.3b", {"ssd_scan"})
    moe = run(phase_moe_serving)
    run(phase_serving_cpu, "qwen2-moe-a2.7b", {"flash_attention"},
        attn_impl_train="pallas")
    run(phase_serving_cpu, "jamba-1.5-large-398b",
        {"flash_attention", "ssd_scan"}, attn_impl_train="pallas")
    print(f"times on {kind} ({smi}); ms, plain_ms and library_ms are "
          "CUDA-event medians of 20 runs, each after evicting the L2:")
    kernels = run(phase_times, main_path, worst)
    flash_entry = run(phase_flash_times, {SERVE["arch"]: serving,
                                          MOE_SERVE["arch"]: moe}, worst)
    kernels.append(flash_entry)
    ssd_entry = run(phase_ssd_times, mamba, worst)
    kernels.append(ssd_entry)
    run(phase_examples)
    par = run(phase_parallel, smi)
    sharded_launches = {
        "flash_attention": sum(par[k]["launches"]["flash_attention"]
                               for k in ("olmo", "moe", "jamba")),
        "ssd_scan": sum(par[k]["launches"]["ssd_scan"]
                        for k in ("mamba", "jamba")),
        "ssd_scan_bwd": par["mamba_train"]["launches"]["ssd_scan_bwd"]}
    for k in kernels:
        k["launches_sharded"] = sharded_launches.get(k["name"], 0)
    # the dry run's CPU children and the train_4k cells' reckonings, beside
    # the training phases (checkpoint I/O, then device-bound steps)
    dry, (reckoners, train_reckoned) = start_dryrun(), start_reckonings()
    try:
        # after the timed phases: run before them once, it was followed by
        # six profiler sessions in a row that recorded too few device events
        run(phase_training)
        mtrain = run(phase_mamba_training)
        # the forward kernel held against the plain version at the training
        # shape
        ssd_entry["max_abs_err"] = max(ssd_entry["max_abs_err"],
                                       mtrain["fwd_max_abs_err"])
        main_bwd = mtrain["per_shape"][0]       # the training step's shape
        bwd_entry = {
            "name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + ss.BWD_SOURCE,
            "replaces": KERNELS["ssd_scan_bwd"],
            "launches": mtrain["launches"]["ssd_scan_bwd"],
            "launches_per_step": mtrain["per_step"]["ssd_scan_bwd"],
            "launches_sharded": sharded_launches["ssd_scan_bwd"],
            # the float32 route's, which the main path trains through; each
            # input type's beside it, also as a share of the largest
            # gradient
            "max_abs_err": mtrain["max_err"]["float32"]["max_abs_err"],
            "max_err_by_dtype": mtrain["max_err"],
            "ms": main_bwd["ms"], "plain_ms": main_bwd["plain_ms"],
            "bound_ms": main_bwd["bound_ms"],
            "bound_by": main_bwd["bound_by"],
            "library_ms": None, "ptxas": mtrain["ptxas"],
            "per_shape": mtrain["per_shape"]}
        kernels.append(bwd_entry)
        train_4k = run(phase_train_4k, train_reckoned)["mamba2-1.3b"]
    finally:
        run(phase_dryrun, dry)
        reckoners.shutdown(cancel_futures=True)
    path = "mamba2-1.3b train_4k bfloat16"
    for entry in (ssd_entry, bwd_entry):
        n = train_4k["launches"][entry["name"]]
        entry.setdefault("launches_by_path", {})[path] = n
        entry["launches"] += n
    for errs in train_4k["layer_err"].values():
        fold_errs(bwd_entry["max_err_by_dtype"], torch.bfloat16, errs)
    bwd_entry["per_shape"].append(train_4k["times"])
    production = run(phase_production_cells)
    entries = {e["name"]: e for e in (flash_entry, ssd_entry)}
    for cell in production.values():
        entry = entries[cell["kernel"]]
        entry.setdefault("launches_by_path", {}).update(
            cell["launches_by_path"])
        entry["launches"] += sum(cell["launches_by_path"].values())
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   *cell["layer_err"].values(),
                                   *cell["every_layer_err"])
        entry["per_shape"].append(cell["times"])
    print("phase walls: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in walls.items()))
    print(f"total wall: {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
