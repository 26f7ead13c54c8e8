"""One card's memory for a production cell, reckoned before it runs.

  PYTHONPATH=src python -m repro_torch.launch.cell_memory [--arch A ...]

The reference's production cells (``configs/shapes.py``) run
``prefill_32k`` as ``T.prefill(params, cfg, batch, 32768,
dtype=bfloat16)`` on bfloat16 weights (``src/repro/launch/dryrun.py:77``)
for a global batch of 32, ``decode_32k`` as a ``decode_step`` against a
32,768-position bfloat16 cache for 128, ``long_500k`` as a ``decode_step``
against a 524,288-position cache for 1 (the archs ``cell_applicable``
gives it: sub-quadratic ones), and ``train_4k`` as
``make_train_step(cfg, AdamWConfig(moment_dtype=cfg.opt_dtype),
num_microbatches=TRAIN_MICROBATCHES[arch])`` on bfloat16 weights and
moments at ``cfg.opt_dtype`` for 256 rows of 4,096 tokens
(``dryrun.py:53-70``).  One card may hold fewer rows.  ``reckon`` runs a
cell at B rows on meta tensors (shapes only, nothing allocated; the kernel
wrappers give their outputs' shapes) under the dry run's counter
(``dryrun._CellCost``) and returns the bytes of the bfloat16 weights, of
the cache (prefill, decode) or the optimizer state (train), and the peak
of the storage the call makes (its results and the cache included) on top
of what it is handed.  A decode cell (``decode_32k``, ``long_500k``) is
reckoned as ``chip_smoke.py``'s production phase runs it: a prefill of
S - ``DECODE_STEPS`` tokens into an S-position cache, then a decode step
(each of its ``DECODE_STEPS`` steps makes the same storage: the prefill
allocates the whole cache).  The train
cell is one step on a batch of ``launch/specs.py:train_input_specs``'
shapes at B rows; the weights and the optimizer state are held (handed
in), and the step's new trees are made, as the port's step is functional
where the reference donates both (``dryrun.py:69``).  ``largest_batch`` is
the largest power of two up to the cell's global batch (a train cell's
rows divisible by its microbatches) whose held bytes plus peak fit
``budget``; ``ROWS`` holds what it gives for each arch at ``BUDGET_BYTES``
in both 32k cells, ``LONG_ROWS`` in ``long_500k`` and ``TRAIN_ROWS`` in
``train_4k``: the rows ``chip_smoke.py`` runs
(``tests/test_torch_cell_memory.py`` holds them together).

These are counts from shapes, with no allocator: the caching allocator's
rounding and fragmentation, the kernels' own scratch (the SSD kernel's
float32 C B^T, B G S 64 4 bytes) and the CUDA context are not in them,
hence a budget below the card's 80 GB.  No number here was measured on any
device.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.shapes import ShapeCell, cell_applicable
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import _CellCost
from repro_torch.launch.optconfig import TRAIN_MICROBATCHES
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.loop import make_train_step
from repro_torch.tree import tree_leaves

__all__ = ["ROWS", "LONG_ROWS", "TRAIN_ROWS", "DECODE_STEPS",
           "BUDGET_BYTES", "prefill_inputs", "reckon", "largest_batch", "main"]

# the production cells' archs one card holds whole in bfloat16, and the rows
# of both cells that ``largest_batch`` gives them at ``BUDGET_BYTES``
ROWS = {"olmo-1b": 8, "mamba2-1.3b": 16, "qwen2-moe-a2.7b": 4,
        "musicgen-large": 4, "pixtral-12b": 4, "yi-6b": 8, "minitron-8b": 4}
# the archs whose long_500k cell ``chip_smoke.py`` runs, and its rows (the
# cell's global batch is 1)
LONG_ROWS = {"mamba2-1.3b": 1}
# the archs whose train_4k step ``chip_smoke.py`` runs, and the rows
# ``largest_batch`` gives them at ``BUDGET_BYTES``
TRAIN_ROWS = {"olmo-1b": 16, "mamba2-1.3b": 64}
DECODE_STEPS = 16
BUDGET_BYTES = 72e9     # of the card's 80 GB, see the module docstring


def prefill_inputs(cfg, rows: int, seq: int, device,
                   generator: torch.Generator | None = None) -> dict:
    """A prefill's batch of ``rows`` sequences of ``seq`` positions: random
    token ids (``(rows, S, K)`` for K codebooks), and for a patch frontend
    its ``n_patches`` bfloat16 patches ahead of ``seq - n_patches`` text
    tokens (``launch/specs.py``'s prefill inputs)."""
    text = seq - cfg.n_patches if cfg.frontend == "patch" else seq
    shape = (rows, text) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    batch = {"tokens": torch.randint(1, cfg.vocab, shape, dtype=torch.int32,
                                     generator=generator, device=device)}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.randn(
            (rows, cfg.n_patches, cfg.patch_dim), generator=generator,
            device=device).to(torch.bfloat16)
    return batch


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _microbatches(cfg, cell: ShapeCell) -> int:
    """A train cell's microbatches (the arch's ``TRAIN_MICROBATCHES``); one
    for the other cells."""
    return TRAIN_MICROBATCHES.get(cfg.name, 1) if cell.kind == "train" \
        else 1


def reckon(cfg, cell: ShapeCell, rows: int) -> dict:
    """Bytes of ``cell`` at ``rows`` rows, bfloat16 weights, from shapes:
    ``params``, ``cache`` (none in a train cell), ``opt`` (the optimizer
    state a train cell holds; none otherwise), ``peak`` (made during the
    call, above what it is handed) and ``total`` (weights, optimizer state
    and peak).  A train cell's step takes the arch's
    ``TRAIN_MICROBATCHES`` microbatches."""
    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    p = _bytes(params)
    if cell.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype)
        opt = adamw_init(params, opt_cfg)
        batch = S.train_input_specs(cfg, dataclasses.replace(
            cell, global_batch=rows))
        step = make_train_step(cfg, opt_cfg, num_microbatches=_microbatches(
            cfg, cell))
        with _CellCost((params, opt, batch)) as cost:
            step(params, opt, batch)
        o = _bytes(opt)
        return {"params": p, "cache": 0, "opt": o, "peak": cost.peak,
                "total": p + o + cost.peak}
    decode = cell.kind == "decode"
    batch = prefill_inputs(cfg, rows, cell.seq_len - decode * DECODE_STEPS,
                           "meta")

    def run():
        logits, cache = T.prefill(params, cfg, batch, cell.seq_len,
                                  dtype=torch.bfloat16)
        if decode:
            logits, cache = T.decode_step(params, cfg,
                                          batch["tokens"][:, :1], cache)
        return logits, cache

    with _CellCost((params, batch)) as cost:
        _, cache = run()
    return {"params": p, "cache": _bytes(cache["blocks"]), "opt": 0,
            "peak": cost.peak, "total": p + cost.peak}


def largest_batch(cfg, cell: ShapeCell, budget: float = BUDGET_BYTES
                  ) -> tuple:
    """(rows, ``reckon``'s bytes) of the largest power of two up to the
    cell's global batch that fits ``budget`` (in a train cell, divisible by
    its microbatches); (0, None) if none does."""
    m = _microbatches(cfg, cell)
    rows = cell.global_batch
    while rows >= m and rows % m == 0:
        got = reckon(cfg, cell, rows)
        if got["total"] <= budget:
            return rows, got
        rows //= 2
    return 0, None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=list(ROWS))
    args = ap.parse_args(argv)
    for arch in args.arch:
        cfg = get_arch(arch, attn_impl_train="pallas")
        names = ["prefill_32k", "decode_32k"]
        if cell_applicable(cfg, SHAPES["long_500k"]):
            names.append("long_500k")
        if arch in TRAIN_ROWS:
            names.append("train_4k")
        for name in names:
            cell = SHAPES[name]
            if cell.kind == "train":
                # the reference trains through the chunked attention
                cfg = get_arch(arch)
            rows, got = largest_batch(cfg, cell)
            held = (f"cache {got['cache']} B" if cell.kind != "train"
                    else f"optimizer state {got['opt']} B") if got else ""
            print(f"{arch} {name}: {rows} of {cell.global_batch} rows fit "
                  f"{BUDGET_BYTES / 1e9} GB"
                  + (f" (weights {got['params']} B, {held}, "
                     f"peak {got['peak']} B, total {got['total']} B)"
                     if got else ""))


if __name__ == "__main__":
    main()
