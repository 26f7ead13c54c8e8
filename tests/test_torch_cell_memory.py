"""What the production-cell phase of ``chip_smoke.py`` stands on, on the CPU.

* ``kernels.ref.flash_attention_ref`` with ``q_start`` gives rows of the
  full output without its (S, S) scores: the phase and the 32k card test
  hold the kernel's last queries against it.
* The flash wrapper on meta tensors gives its output's shape and type and
  launches nothing, as the SSD wrapper does.
* ``launch/cell_memory.py`` reckons a cell's bytes from shapes: its
  weights and cache equal what ``init_params`` and ``prefill`` allocate on
  the CPU, its peak holds them, its inputs are the reference's
  ``launch/specs.py`` prefill inputs, and ``largest_batch`` takes the
  largest power of two that fits.
* The long cell (``long_500k``) is a decode cell of its own: mamba2-1.3b's
  state does not grow with the sequence, so it reckons the cache of
  ``decode_32k`` at one row, and ``LONG_ROWS`` is what ``largest_batch``
  gives at its shapes.
* The train cell (``train_4k``) is reckoned as the reference's
  ``_lower_cell`` builds it: bfloat16 weights and moments at
  ``cfg.opt_dtype``, held (handed in), one ``make_train_step`` step on a
  ``train_input_specs`` batch, whose new trees are made; ``largest_batch``
  keeps its rows divisible by the microbatches, and ``TRAIN_ROWS`` is what
  it gives at the cell's own shapes.
* On a mesh (``reckon(..., mesh=)``, ``--mesh data=1,model=4``) a cell is
  reckoned for one device over meta DTensors on a fake four-rank group:
  its weights and cache are the shard arithmetic of ``param_specs`` and
  ``cache_specs``, and ``MESH4_ROWS`` is what ``largest_batch`` gives
  there at the production cells' shapes.  A train cell there is laid out
  as the dry run lays it out: its weights are the shard arithmetic of
  ``param_specs`` and its moments that of ``zero1_specs``, on (data 1,
  model 4) and on (data 2, model 2), and ``--mesh`` prints it
  (``tests/test_torch_mesh_train_rows_*.py`` reckon ``MESH4_TRAIN`` at
  full size).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_arch, smoke_config
from repro_torch.configs.shapes import ShapeCell, cell_applicable
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import cell_memory as cm
from repro_torch.launch.optconfig import TRAIN_MICROBATCHES
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("hq,hkv,causal,window,start,n", [
    (4, 4, True, None, 0, 16), (4, 2, True, None, 40, 24),
    (6, 1, True, 9, 17, 31), (2, 2, False, None, 8, 8)])
def test_flash_ref_rows_equal_the_full_outputs_rows(hq, hkv, causal, window,
                                                    start, n):
    g = torch.Generator().manual_seed(hq + start)
    s, d = 64, 16
    q, k, v = (torch.randn((2, h, s, d), generator=g)
               for h in (hq, hkv, hkv))
    full = ref.flash_attention_ref(q, k, v, causal=causal,
                                   swa_window=window)
    # causal rows need keys only up to their last position
    end = start + n if causal else s
    got = ref.flash_attention_ref(q[:, :, start:start + n], k[:, :, :end],
                                  v[:, :, :end], causal=causal,
                                  swa_window=window, q_start=start)
    torch.testing.assert_close(got, full[:, :, start:start + n], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_on_meta_gives_shapes_and_launches_nothing(dtype):
    q = torch.empty((2, 8, 128, 64), dtype=dtype, device="meta")
    kv = torch.empty((2, 2, 128, 64), dtype=dtype, device="meta")
    fa.reset_launches()
    out = fa.flash_attention_cuda(q, kv, kv)
    assert out.device.type == "meta" and out.dtype == dtype
    assert out.shape == q.shape
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b", "qwen2-moe-a2.7b",
                                  "musicgen-large", "pixtral-12b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_reckon_counts_the_weights_and_cache_prefill_allocates(arch, kind):
    cfg = smoke_config(arch, attn_impl_train="pallas")
    cell = ShapeCell("small", kind, 64, 8)
    rows = 2
    got = cm.reckon(cfg, cell, rows)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.bfloat16, device="cpu")
    steps = cm.DECODE_STEPS if kind == "decode" else 0
    batch = cm.prefill_inputs(cfg, rows, cell.seq_len - steps, "cpu",
                              torch.Generator().manual_seed(0))
    _, cache = T.prefill(params, cfg, batch, cell.seq_len,
                         dtype=torch.bfloat16)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))
    assert got["params"] == nbytes(params)
    assert got["cache"] == nbytes(cache["blocks"])
    assert got["cache"] < got["peak"] and got["total"] == (got["params"]
                                                         + got["peak"])


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large", "olmo-1b"])
def test_prefill_inputs_are_the_reference_specs(arch):
    """At the production cell's own shapes (on meta): the reference's
    ``prefill_input_specs``, patches in bfloat16 ahead of the text."""
    cfg, cell = get_arch(arch), SHAPES["prefill_32k"]
    want = jspecs.prefill_input_specs(jget_arch(arch),
                                      JSHAPES["prefill_32k"])
    got = cm.prefill_inputs(cfg, cell.global_batch, cell.seq_len, "meta")
    assert set(got) == set(want)
    for key, spec in want.items():
        assert tuple(got[key].shape) == tuple(spec.shape)
        assert str(got[key].dtype).removeprefix("torch.") == \
            jnp.dtype(spec.dtype).name


def test_largest_batch_takes_the_largest_power_of_two_that_fits():
    cfg = smoke_config("olmo-1b", attn_impl_train="pallas")
    cell = ShapeCell("small", "prefill", 64, 8)
    totals = {r: cm.reckon(cfg, cell, r)["total"] for r in (1, 2, 4, 8)}
    assert totals[1] < totals[2] < totals[4] < totals[8]
    assert cm.largest_batch(cfg, cell, totals[8])[0] == 8
    assert cm.largest_batch(cfg, cell, totals[4] + 1)[0] == 4
    rows, got = cm.largest_batch(cfg, cell, totals[2])
    assert rows == 2 and got["total"] == totals[2]
    assert cm.largest_batch(cfg, cell, totals[1] - 1) == (0, None)
    assert np.isfinite(totals[8])


@pytest.mark.parametrize("arch", list(cm.ROWS))
def test_rows_are_the_largest_batch_that_fits(arch):
    """``ROWS``, the rows ``chip_smoke.py`` runs, is what ``largest_batch``
    gives at the production cells' own shapes (on meta), in both cells:
    those rows fit the budget and twice as many do not."""
    cfg = get_arch(arch, attn_impl_train="pallas")
    rows = cm.ROWS[arch]
    for name in ("prefill_32k", "decode_32k"):
        cell = SHAPES[name]
        assert rows < cell.global_batch
        assert cm.reckon(cfg, cell, rows)["total"] <= cm.BUDGET_BYTES
        assert cm.reckon(cfg, cell, 2 * rows)["total"] > cm.BUDGET_BYTES


@pytest.mark.parametrize("arch", list(cm.LONG_ROWS))
def test_long_rows_are_the_largest_batch_that_fits(arch):
    """``LONG_ROWS``, the rows of ``chip_smoke.py``'s long_500k cell, is
    what ``largest_batch`` gives at the cell's own shapes (on meta): the
    cell applies to the arch, the rows fit the budget, and twice as many
    exceed the budget or the cell's global batch."""
    cfg, cell = get_arch(arch, attn_impl_train="pallas"), SHAPES["long_500k"]
    rows = cm.LONG_ROWS[arch]
    assert cell_applicable(cfg, cell)
    rows_got, got = cm.largest_batch(cfg, cell)
    assert rows_got == rows and got["total"] <= cm.BUDGET_BYTES
    assert 2 * rows > cell.global_batch \
        or cm.reckon(cfg, cell, 2 * rows)["total"] > cm.BUDGET_BYTES


def test_long_cell_reckons_the_decode_cells_cache_at_one_row():
    """mamba2-1.3b's cache is its conv windows and SSM state, whatever the
    length: long_500k (a prefill of 524,272 positions into 524,288) holds
    the bytes decode_32k holds at one row, the bytes of the cache
    ``cache_leaf_shapes`` lays out; only the prefill's peak grows."""
    cfg = get_arch("mamba2-1.3b", attn_impl_train="pallas")
    long = cm.reckon(cfg, SHAPES["long_500k"], 1)
    short = cm.reckon(cfg, SHAPES["decode_32k"], 1)
    want = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
               for leaf in tree_leaves(T.cache_leaf_shapes(
                   cfg, 1, SHAPES["long_500k"].seq_len,
                   torch.bfloat16)["blocks"]))
    assert long["cache"] == short["cache"] == want
    assert long["params"] == short["params"]
    assert long["peak"] > 8 * short["peak"]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b", "qwen2-moe-a2.7b",
                                  "pixtral-12b", "jamba-1.5-large-398b"])
def test_reckon_counts_the_weights_and_optimizer_state_a_train_step_holds(
        arch):
    """The weights and the optimizer state (moments at ``opt_dtype``: jamba
    keeps bfloat16 ones) are what ``init_params`` and ``adamw_init``
    allocate on the CPU, counted as held; the step makes new trees of
    both, so its peak is at least their bytes again."""
    cfg = smoke_config(arch)
    got = cm.reckon(cfg, ShapeCell("small", "train", 64, 16), 16)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.bfloat16, device="cpu")
    opt = adamw_init(params, AdamWConfig(moment_dtype=cfg.opt_dtype))
    assert got["params"] == _nbytes(params)
    assert got["opt"] == _nbytes(opt)
    assert got["cache"] == 0
    assert got["peak"] >= got["params"] + got["opt"]
    assert got["total"] == got["params"] + got["opt"] + got["peak"]


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b"])
def test_a_train_cell_is_not_reckoned_as_a_prefill(arch):
    """The same rows and length as a train cell and as a prefill: the train
    cell holds an optimizer state and no cache, and its step (gradients,
    new weights and moments) makes more than the prefill's forward and
    cache."""
    cfg = smoke_config(arch)
    train = cm.reckon(cfg, ShapeCell("small", "train", 64, 8), 8)
    prefill = cm.reckon(cfg, ShapeCell("small", "prefill", 64, 8), 8)
    assert train["cache"] == 0 < train["opt"]
    assert prefill["opt"] == 0 < prefill["cache"]
    assert train["peak"] > prefill["peak"]


def test_largest_train_batch_keeps_rows_divisible_by_the_microbatches():
    """mamba2-1.3b takes 8 microbatches: 16 and 8 rows are tried, fewer
    are not (the step refuses them)."""
    cfg = smoke_config("mamba2-1.3b")
    cell = ShapeCell("small", "train", 128, 16)
    assert TRAIN_MICROBATCHES[cfg.name] == 8
    totals = {r: cm.reckon(cfg, cell, r)["total"] for r in (8, 16)}
    assert totals[8] < totals[16]
    assert cm.largest_batch(cfg, cell, totals[16])[0] == 16
    assert cm.largest_batch(cfg, cell, totals[8])[0] == 8
    assert cm.largest_batch(cfg, cell, totals[8] - 1) == (0, None)
    with pytest.raises(ValueError, match="not divisible into 8"):
        cm.reckon(cfg, cell, 4)


@pytest.mark.parametrize("arch", list(cm.TRAIN_ROWS))
def test_train_rows_are_the_largest_batch_that_fits(arch):
    """``TRAIN_ROWS``, the rows of ``chip_smoke.py``'s train_4k phase, is
    what ``largest_batch`` gives at the cell's own shapes (on meta) with
    the arch's ``TRAIN_MICROBATCHES``: they divide into the microbatches,
    fit the budget, and twice as many do not."""
    cfg, cell = get_arch(arch), SHAPES["train_4k"]
    rows, m = cm.TRAIN_ROWS[arch], TRAIN_MICROBATCHES[arch]
    assert rows % m == 0 and rows < cell.global_batch
    assert cm.reckon(cfg, cell, rows)["total"] <= cm.BUDGET_BYTES
    assert cm.reckon(cfg, cell, 2 * rows)["total"] > cm.BUDGET_BYTES


def _shard_bytes(tree, specs, msd) -> int:
    """Bytes of one device's shards of ``tree`` laid out by ``specs`` on a
    mesh of ``msd``: each leaf's bytes over the ranks of every axis its
    spec names (``test_torch_parallel.py``'s shard arithmetic)."""
    from repro_torch.tree import tree_map_with_keys
    out = []

    def one(keys, leaf, spec):
        if not isinstance(leaf, torch.Tensor) and not hasattr(leaf, "shape"):
            return
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        for ax in tuple(spec):
            for a in () if ax is None else ((ax,) if isinstance(ax, str)
                                            else ax):
                n //= msd[a]
        out.append(n)
    tree_map_with_keys(one, tree, specs)
    return sum(out)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mixtral-8x7b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mesh_reckon_bytes_are_the_shard_arithmetic(arch, kind):
    """Smoke qwen1.5-32b (int8 cache) and mixtral-8x7b (ring cache, MoE)
    at tp 4, reckoned for one device of a fake (data 1, model 4) mesh: the
    weights are the shard arithmetic of ``param_specs`` and the cache that
    of ``cache_specs`` on the cache's own leaf shapes, each under the
    one-card reckoning's of the same tp-4 config."""
    from repro_torch.parallel import cache_specs, param_specs
    msd = cm.MESH4
    cfg = smoke_config(arch, tp=4, attn_impl_train="pallas")
    cell = ShapeCell("small", kind, 64, 8)
    rows = 2
    with cm.fake_mesh(msd) as mesh:
        got = cm.reckon(cfg, cell, rows, mesh)
    one_card = cm.reckon(cfg, cell, rows)
    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    assert got["params"] == _shard_bytes(
        params, param_specs(cfg, params, msd), msd)
    leaves = T.cache_leaf_shapes(cfg, rows, cell.seq_len, torch.bfloat16)
    assert got["cache"] == _shard_bytes(
        leaves["blocks"], cache_specs(cfg, leaves, msd)["blocks"], msd)
    # a quarter of the K/V; the ring's slot positions are replicated
    assert got["cache"] < one_card["cache"] <= 4 * got["cache"]
    assert got["params"] < one_card["params"]
    assert got["total"] == got["params"] + got["peak"] > got["cache"]


@pytest.mark.parametrize("arch", list(cm.MESH4_ROWS))
def test_mesh4_rows_are_the_largest_batch_that_fits(arch):
    """``MESH4_ROWS``, the rows ``chip_smoke.py --cards 4`` runs, is what
    ``largest_batch`` gives for a device of ``MESH4`` at the production
    cells' own shapes, in both cells, with ``build_cfg``'s tp-4 config:
    those rows fit the budget and twice as many do not, and one card could
    not hold the weights whole."""
    rows = cm.MESH4_ROWS[arch]
    with cm.fake_mesh(cm.MESH4) as mesh:
        for name in ("prefill_32k", "decode_32k"):
            cell = SHAPES[name]
            cfg = cm.mesh_cfg(arch, cm.MESH4, cell.kind)
            assert cfg.tp == 4 and cfg.attn_impl_train == "pallas"
            assert rows < cell.global_batch
            got = cm.reckon(cfg, cell, rows, mesh)
            assert got["total"] <= cm.BUDGET_BYTES
            assert cm.reckon(cfg, cell, 2 * rows, mesh)["total"] > \
                cm.BUDGET_BYTES
    assert 4 * got["params"] > cm.BUDGET_BYTES


def test_mesh_cli_reckons_each_cell_for_a_device(capsys):
    """``--mesh data=1,model=4`` parses into the mesh in its order and
    prints each 32k cell's rows for a device of it."""
    assert cm._mesh_arg("data=1,model=4") == {"data": 1, "model": 4}
    cm.main(["--arch", "mixtral-8x7b", "--mesh", "data=1,model=4"])
    lines = capsys.readouterr().out.splitlines()
    rows = cm.MESH4_ROWS["mixtral-8x7b"]
    assert [line.split(" rows")[0] for line in lines] == [
        f"mixtral-8x7b prefill_32k: {rows} of 32",
        f"mixtral-8x7b decode_32k: {rows} of 128"]
    assert all("a device of {'data': 1, 'model': 4}" in line
               for line in lines)


@pytest.mark.parametrize("mesh_shape", [{"data": 1, "model": 4},
                                        {"data": 2, "model": 2}])
def test_mesh_train_reckon_bytes_are_the_shard_arithmetic(mesh_shape):
    """Smoke yi-6b's train cell (tp the 'model' size, the batch over
    'data', 8 microbatches), reckoned for one device of a fake mesh: the
    weights are the shard arithmetic of ``param_specs`` (over tp), the
    moments that of ``zero1_specs`` over 'data' (m and v at float32, and
    the step counter), the step's collectives are counted, and the total
    holds weights, moments and the step's peak."""
    from repro_torch.parallel import param_specs, zero1_specs
    cfg = smoke_config("yi-6b", tp=mesh_shape["model"],
                       batch_axes=("data",), n_heads=8, n_kv_heads=4)
    cell = ShapeCell("small", "train", 64, 256)
    rows = 8 * mesh_shape["data"]
    with cm.fake_mesh(mesh_shape) as mesh:
        got = cm.reckon(cfg, cell, rows, mesh)
    params = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    specs = param_specs(cfg, params, mesh_shape)
    moments = adamw_init(params, AdamWConfig(moment_dtype=cfg.opt_dtype))
    zs = zero1_specs(specs, params, mesh_shape, axes=("data",))
    assert got["params"] == _shard_bytes(params, specs, mesh_shape)
    assert got["opt"] == 2 * _shard_bytes(moments["m"], zs, mesh_shape) + 4
    one_card = cm.reckon(cfg, cell, rows)
    assert got["params"] < one_card["params"]
    assert got["opt"] < one_card["opt"]
    assert got["total"] == got["params"] + got["opt"] + got["peak"]
    counts = got["collectives"]["counts"]
    assert counts["all-reduce"] > 0
    # over 'data' each gradient is reduce-scattered into its moments' shard
    # and the new weights all-gathered; on a data axis of one, neither
    assert (counts["reduce-scatter"] > 0) == (mesh_shape["data"] > 1)
    assert (counts["all-gather"] > 0) == (mesh_shape["data"] > 1)


def test_mesh_cli_reckons_the_train_cell(capsys, monkeypatch):
    """``--mesh data=2,model=2 --shape train_4k`` reckons the train cell for
    a device of that mesh at ``MESH4_TRAIN``'s rows, and an arch it does
    not hold at its smallest rows (its microbatches times 'data'; smoke
    archs in place of the full ones, the cell cut to 64 tokens)."""
    monkeypatch.setattr(cm, "SHAPES", dict(SHAPES, train_4k=ShapeCell(
        "train_4k", "train", 64, 256)))
    monkeypatch.setattr(cm, "mesh_cfg", lambda arch, msd, kind: smoke_config(
        arch, tp=msd["model"], batch_axes=("data",)))
    where = "on a device of {'data': 2, 'model': 2}: weights "
    rows = cm.MESH4_TRAIN["musicgen-large"][1]
    for argv, want in ((["--arch", "musicgen-large"], rows),
                       (["--arch", "minitron-8b"], 8 * 2)):
        cm.main(argv + ["--mesh", "data=2,model=2", "--shape", "train_4k"])
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 1
        assert lines[0].startswith(
            f"{argv[1]} train_4k: {want} of 256 rows (8 microbatches) "
            + where)
        assert "optimizer state" in lines[0]
        assert lines[0].endswith(f"within {cm.BUDGET_BYTES / 1e9} GB")
    assert cm.mesh_cells("musicgen-large") == ["train_4k"]
    assert cm.mesh_cells("mixtral-8x7b") == ["prefill_32k", "decode_32k"]
