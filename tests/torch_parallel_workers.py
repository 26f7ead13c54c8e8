"""The gloo side of ``tests/test_torch_parallel.py``: the spawned ranks'
entry and a one-rank group.

The checks themselves are ``repro_torch.launch.mesh_checks`` (re-exported
here), which ``chip_smoke.py --cards 4`` runs on four cards under NCCL.
Each rank runs every check and records, for each, its numbers (or the
traceback if it raised) in a JSON file of its own.  This module imports no
JAX: the spawned ranks import it by name.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch import mesh_checks
from repro_torch.launch.mesh_checks import *  # noqa: F401,F403
from repro_torch.launch.mesh_checks import CHECKS, WORLD


def run(rank: int, init_file: str, out_dir: str) -> None:
    """Entry of a spawned rank: every check in turn, each one's numbers or
    traceback written to ``out_dir/rank<rank>.json``."""
    mesh_checks.OUT_DIR = out_dir
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    try:
        for name, fn in CHECKS.items():
            try:
                results[name] = fn(rank)
            except Exception:      # recorded for the test to report
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)


@contextlib.contextmanager
def one_rank_group(tmp_dir, backend: str = "gloo"):
    """A process group of this process alone (gloo, or NCCL on the card; its
    store a file under ``tmp_dir``), destroyed on exit."""
    store = dist.FileStore(os.path.join(str(tmp_dir), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()
