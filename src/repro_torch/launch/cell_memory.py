"""One card's memory for a production cell, reckoned before it runs.

  PYTHONPATH=src python -m repro_torch.launch.cell_memory [--arch A ...]
      [--mesh data=1,model=4 [--shape prefill_32k decode_32k train_4k]]

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

On a mesh (``--mesh data=1,model=4``; ``reckon(..., mesh=)``) a cell is
reckoned for one device of it: the config is ``build_cfg(arch, mesh shape,
kind=...)`` (tp the 'model' axis), the weights, the batch and the cache are
meta DTensors laid out by ``param_specs``, ``batch_specs`` and
``cache_specs`` on a ``"fake"`` process group of the mesh's ranks
(``dryrun.fake_world``), and every byte is this rank's shard, counted as
the dry run counts it.  On (data 1, model 4) every rank holds the same
bytes (the batch is replicated, every split even), so rank 0's are the
fullest device's.  ``MESH4_ROWS`` holds what ``largest_batch`` gives there
in both 32k cells for the archs one card cannot hold: the rows
``chip_smoke.py --cards 4`` runs.  A train cell on a mesh is laid out as
the dry run lays it out (``dryrun._trace_cell``: ZeRO-1 moments over
'data', or over 'data' and 'model' in the ``dp`` and ``fsdp2d`` layouts,
the batch over ``batch_specs``, its rows divisible by the microbatches
times the batch's ranks), and its reckoning also holds the dry run's count
of the step's collectives; ``MESH4_TRAIN`` holds each four-card train
cell's mesh and rows.  ``--mesh`` reckons the cells ``chip_smoke.py
--cards 4`` runs of each arch (``--shape`` others): a 32k cell at the rows
``largest_batch`` gives, a train cell at ``MESH4_TRAIN``'s rows, else at
its smallest (its microbatches times the ranks its batch is split
over).

These are counts from shapes, with no allocator: the caching allocator's
rounding and fragmentation, the kernels' own scratch (the SSD kernel's
float32 C B^T, B G S 64 4 bytes) and the CUDA context are not in them,
hence a budget below the card's 80 GB.  No number here was measured on any
device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.shapes import ShapeCell, cell_applicable
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import (_CellCost, _nbytes, _trace_cell,
                                      fake_world)
from repro_torch.launch.mesh import make_mesh, mesh_shape_dict
from repro_torch.launch.optconfig import TRAIN_MICROBATCHES, build_cfg
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import batch_specs, distribute_tree, param_specs
from repro_torch.train.loop import make_train_step

__all__ = ["ROWS", "LONG_ROWS", "TRAIN_ROWS", "MESH4", "MESH4_ROWS",
           "MESH4_TRAIN", "DECODE_STEPS",
           "BUDGET_BYTES", "prefill_inputs", "reckon", "largest_batch",
           "train_rows_unit",
           "batch_ranks", "fake_mesh", "mesh_cfg", "main"]

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
# the mesh of the production cells one card cannot hold: the reference's
# production layout ('model' the tensor-parallel axis) on four cards
MESH4 = {"data": 1, "model": 4}
# those archs, and the rows of both 32k cells that ``largest_batch`` gives
# them on ``MESH4`` at ``BUDGET_BYTES`` a card
MESH4_ROWS = {"qwen1.5-32b": 4, "mixtral-8x7b": 8}
# the train_4k cells on four cards: each arch's mesh (yi-6b on the
# tensor-parallel ``MESH4``; musicgen-large small enough for 'data' to carry
# ZeRO-1 shards and a split batch) and its rows.  16 rows of 4,096 tokens,
# olmo-1b's one-card train_4k step (``TRAIN_ROWS``), not the 64 and 128
# that ``largest_batch`` gives at ``BUDGET_BYTES`` a card: a device's bytes
# are the moments, the float32 gradients and the update's new trees, not
# the activations (yi-6b reckons 59.84 GB from 8 to 64 rows), and a step at
# 16 rows took 20.9 s (yi-6b) and 33.4 s (musicgen-large) on four H100s,
# of which ``chip_smoke.py --cards 4`` runs three a cell and a 2-layer
# parity inside its wall
MESH4_TRAIN = {"yi-6b": ({"data": 1, "model": 4}, 16),
               "musicgen-large": ({"data": 2, "model": 2}, 16)}
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


@contextlib.contextmanager
def fake_mesh(shape: dict):
    """A cuda-typed ``DeviceMesh`` of ``shape`` on a ``"fake"`` process
    group of its ranks, this process standing in for rank 0."""
    with fake_world(int(torch.tensor(list(shape.values())).prod())):
        yield make_mesh(shape, "cuda")


def mesh_cfg(arch: str, mesh_shape: dict, kind: str):
    """The config a cell of ``kind`` runs on a mesh of ``mesh_shape``:
    ``build_cfg``'s (the reference's production layout), attention through
    the flash kernel in a prefill or decode cell, and through the chunked
    schedule with remat in a train cell, as the reference trains."""
    cfg = build_cfg(arch, mesh_shape, kind=kind)
    return cfg if kind == "train" else cfg.replace(attn_impl_train="pallas")


def _microbatches(cfg, cell: ShapeCell) -> int:
    """A train cell's microbatches (the arch's ``TRAIN_MICROBATCHES``); one
    for the other cells."""
    return TRAIN_MICROBATCHES.get(cfg.name, 1) if cell.kind == "train" \
        else 1


def batch_ranks(cfg, mesh_shape: dict | None) -> int:
    """The ranks a batch's rows are split over: the product of the mesh's
    sizes over ``cfg.batch_axes`` (1 off a mesh)."""
    return math.prod(mesh_shape.get(a, 1) for a in cfg.batch_axes) \
        if mesh_shape else 1


def reckon(cfg, cell: ShapeCell, rows: int, mesh=None) -> dict:
    """Bytes of ``cell`` at ``rows`` rows, bfloat16 weights, from shapes:
    ``params``, ``cache`` (none in a train cell), ``opt`` (the optimizer
    state a train cell holds; none otherwise), ``peak`` (made during the
    call, above what it is handed) and ``total`` (weights, optimizer state
    and peak).  A train cell's step takes the arch's
    ``TRAIN_MICROBATCHES`` microbatches.  On ``mesh`` every byte is one
    device's: its shards; a train cell there is laid out as the dry run
    lays it out (``dryrun._trace_cell``: the weights by ``param_specs``,
    the ZeRO-1 moments by ``zero1_specs``, the batch by ``batch_specs``),
    and ``collectives`` holds its step's collectives as the dry run counts
    them (``commcount.CollectiveCounter.result()``)."""
    if mesh is not None and cell.kind == "train":
        step, args = _trace_cell(cfg, dataclasses.replace(
            cell, global_batch=rows), mesh,
            microbatches=_microbatches(cfg, cell))
        p, o = _nbytes(args[0]), _nbytes(args[1])
        with _CellCost(args) as cost:
            step(*args)
        return {"params": p, "cache": 0, "opt": o, "peak": cost.peak,
                "total": p + o + cost.peak, "collectives": cost.result()}
    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    if mesh is not None:
        msd = mesh_shape_dict(mesh)
        params = distribute_tree(params, param_specs(cfg, params, msd), mesh)
    p = _nbytes(params)
    if cell.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype)
        opt = adamw_init(params, opt_cfg)
        batch = S.train_input_specs(cfg, dataclasses.replace(
            cell, global_batch=rows))
        step = make_train_step(cfg, opt_cfg, num_microbatches=_microbatches(
            cfg, cell))
        with _CellCost((params, opt, batch)) as cost:
            step(params, opt, batch)
        o = _nbytes(opt)
        return {"params": p, "cache": 0, "opt": o, "peak": cost.peak,
                "total": p + o + cost.peak}
    decode = cell.kind == "decode"
    batch = prefill_inputs(cfg, rows, cell.seq_len - decode * DECODE_STEPS,
                           "meta")
    if mesh is not None:
        batch = distribute_tree(batch, batch_specs(cfg, batch, msd), mesh)

    def run():
        logits, cache = T.prefill(params, cfg, batch, cell.seq_len,
                                  dtype=torch.bfloat16)
        if decode:
            logits, cache = T.decode_step(params, cfg,
                                          batch["tokens"][:, :1], cache)
        return logits, cache

    with _CellCost((params, batch)) as cost:
        _, cache = run()
    return {"params": p, "cache": _nbytes(cache["blocks"]), "opt": 0,
            "peak": cost.peak, "total": p + cost.peak}


def train_rows_unit(cfg, cell: ShapeCell, mesh_shape: dict | None) -> int:
    """What a train cell's rows divide into: its microbatches times the
    ranks its batch is split over on a mesh of ``mesh_shape``."""
    return _microbatches(cfg, cell) * batch_ranks(cfg, mesh_shape)


def largest_batch(cfg, cell: ShapeCell, budget: float = BUDGET_BYTES,
                  mesh=None) -> tuple:
    """(rows, ``reckon``'s bytes) of the largest power of two up to the
    cell's global batch that fits ``budget`` (in a train cell, divisible by
    ``train_rows_unit``); (0, None) if none does."""
    m = train_rows_unit(cfg, cell, None if mesh is None else
                        mesh_shape_dict(mesh)) if cell.kind == "train" else 1
    rows = cell.global_batch
    while rows >= m and rows % m == 0:
        got = reckon(cfg, cell, rows, mesh)
        if got["total"] <= budget:
            return rows, got
        rows //= 2
    return 0, None


def _mesh_arg(text: str) -> dict:
    """``data=1,model=4`` -> {"data": 1, "model": 4}, in that order."""
    return {k: int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def _report(arch: str, name: str, cell: ShapeCell, rows: int, got,
            where: str) -> None:
    held = (f"cache {got['cache']} B" if cell.kind != "train"
            else f"optimizer state {got['opt']} B") if got else ""
    print(f"{arch} {name}: {rows} of {cell.global_batch} rows fit "
          f"{BUDGET_BYTES / 1e9} GB{where}"
          + (f" (weights {got['params']} B, {held}, "
             f"peak {got['peak']} B, total {got['total']} B)"
             if got else ""))


def _report_train(arch: str, cfg, cell: ShapeCell, mesh_shape: dict,
                  mesh) -> None:
    """A train cell reckoned for a device of ``mesh`` at ``MESH4_TRAIN``'s
    rows (on its own mesh), else at its smallest."""
    own = MESH4_TRAIN.get(arch)
    rows = own[1] if own and own[0] == mesh_shape else \
        train_rows_unit(cfg, cell, mesh_shape)
    got = reckon(cfg, cell, rows, mesh)
    print(f"{arch} {cell.name}: {rows} of {cell.global_batch} rows "
          f"({_microbatches(cfg, cell)} microbatches) on a device of "
          f"{mesh_shape}: weights {got['params']} B, optimizer state "
          f"{got['opt']} B, peak {got['peak']} B, total {got['total']} B, "
          + ("within" if got["total"] <= BUDGET_BYTES else "over")
          + f" {BUDGET_BYTES / 1e9} GB")


def mesh_cells(arch: str) -> list:
    """The cells ``chip_smoke.py --cards 4`` runs of ``arch``: both 32k
    cells (``MESH4_ROWS``), ``train_4k`` (``MESH4_TRAIN``); all three for
    an arch it runs in neither."""
    names = ["prefill_32k", "decode_32k"] if arch in MESH4_ROWS else []
    names += ["train_4k"] if arch in MESH4_TRAIN else []
    return names or ["prefill_32k", "decode_32k", "train_4k"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="reckon one device of this mesh, e.g. "
                    "data=1,model=4 (the 32k cells and the train cell)")
    ap.add_argument("--shape", nargs="*", default=None, choices=[
        "prefill_32k", "decode_32k", "train_4k"],
                    help="with --mesh: the cells to reckon (default: those "
                    "chip_smoke.py --cards 4 runs of each arch)")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        with fake_mesh(args.mesh) as mesh:
            for arch in args.arch or [*MESH4_ROWS, *MESH4_TRAIN]:
                for name in args.shape or mesh_cells(arch):
                    cell = SHAPES[name]
                    cfg = mesh_cfg(arch, args.mesh, cell.kind)
                    if cell.kind == "train":
                        _report_train(arch, cfg, cell, args.mesh, mesh)
                        continue
                    rows, got = largest_batch(cfg, cell, mesh=mesh)
                    _report(arch, name, cell, rows, got,
                            f" a device of {args.mesh}")
        return
    for arch in args.arch or list(ROWS):
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
            _report(arch, name, cell, rows, got, "")


if __name__ == "__main__":
    main()
