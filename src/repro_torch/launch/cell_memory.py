"""One card's memory for a production cell, reckoned before it runs.

  PYTHONPATH=src python -m repro_torch.launch.cell_memory [--arch A ...]

The reference's production cells (``configs/shapes.py``) run
``prefill_32k`` as ``T.prefill(params, cfg, batch, 32768,
dtype=bfloat16)`` on bfloat16 weights (``src/repro/launch/dryrun.py:77``)
for a global batch of 32, and ``decode_32k`` as a ``decode_step``
against a 32,768-position bfloat16 cache for 128.  One card may hold fewer
rows.  ``reckon`` runs a cell at B rows on meta tensors (shapes only,
nothing allocated; the kernel wrappers give their outputs' shapes) under
the dry run's counter (``dryrun._CellCost``) and returns the bytes of the
bfloat16 weights, of the cache, and the peak of the storage the call makes
(its results and the cache included) on top of the weights.  The decode
cell is reckoned as ``chip_smoke.py``'s production phase runs it: a
prefill of S - ``DECODE_STEPS`` tokens into an S-position cache, then a
decode step (each of its ``DECODE_STEPS`` steps makes the same storage:
the prefill allocates the whole cache).  ``largest_batch`` is the largest
power of two up to the cell's global batch whose weights plus peak fit
``budget``; ``ROWS`` holds what it gives for each arch at
``BUDGET_BYTES`` (the same for both cells), the rows ``chip_smoke.py``
runs (``tests/test_torch_cell_memory.py`` holds the two together).

These are counts from shapes, with no allocator: the caching allocator's
rounding and fragmentation, the kernels' own scratch (the SSD kernel's
float32 C B^T, B G S 64 4 bytes) and the CUDA context are not in them,
hence a budget below the card's 80 GB.  No number here was measured on any
device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.dryrun import _CellCost
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

__all__ = ["ROWS", "DECODE_STEPS", "BUDGET_BYTES", "prefill_inputs",
           "reckon", "largest_batch", "main"]

# the production cells' archs one card holds whole in bfloat16, and the rows
# of both cells that ``largest_batch`` gives them at ``BUDGET_BYTES``
ROWS = {"olmo-1b": 8, "mamba2-1.3b": 16, "qwen2-moe-a2.7b": 4,
        "musicgen-large": 4, "pixtral-12b": 4}
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


def reckon(cfg, cell: ShapeCell, rows: int) -> dict:
    """Bytes of ``cell`` at ``rows`` rows, bfloat16, from shapes:
    ``params``, ``cache``, ``peak`` (made during the call, above the
    weights) and ``total`` (weights plus peak)."""
    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
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
    p = _bytes(params)
    return {"params": p, "cache": _bytes(cache["blocks"]),
            "peak": cost.peak, "total": p + cost.peak}


def largest_batch(cfg, cell: ShapeCell, budget: float = BUDGET_BYTES
                  ) -> tuple:
    """(rows, ``reckon``'s bytes) of the largest power of two up to the
    cell's global batch that fits ``budget``; (0, None) if one row does
    not."""
    rows = cell.global_batch
    while rows >= 1:
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
        for name in ("prefill_32k", "decode_32k"):
            cell = SHAPES[name]
            rows, got = largest_batch(cfg, cell)
            full = reckon(cfg, cell, cell.global_batch)
            print(f"{arch} {name}: {rows} of {cell.global_batch} rows fit "
                  f"{BUDGET_BYTES / 1e9} GB"
                  + (f" (weights {got['params']} B, cache {got['cache']} B, "
                     f"peak {got['peak']} B, total {got['total']} B)"
                     if got else "")
                  + f"; the global batch would take {full['total']} B "
                  f"(cache {full['cache']} B)")


if __name__ == "__main__":
    main()
