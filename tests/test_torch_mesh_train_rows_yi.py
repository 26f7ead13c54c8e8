"""``cell_memory.MESH4_TRAIN`` reckoned at full size, one arch a file (a
full-size reckoning of a train cell on a mesh takes minutes on a CPU):
yi-6b's ``train_4k`` cell on (data 1, model 4), as ``chip_smoke.py
--cards 4`` runs it.

The rows fit ``BUDGET_BYTES`` for a device of the mesh and divide into the
arch's microbatches times the ranks of 'data' (``train_rows_unit``).  They
are not the largest that fit (``MESH4_TRAIN``'s comment says why).  The
config is the reference's (``build_cfg``'s, the chunked attention with
remat), and the reckoning counts the step's collectives as the dry run
does.
"""
from repro_torch.configs import SHAPES
from repro_torch.launch import cell_memory as cm


def check_mesh_train_rows(arch: str) -> None:
    mshape, rows = cm.MESH4_TRAIN[arch]
    cell = SHAPES["train_4k"]
    cfg = cm.mesh_cfg(arch, mshape, "train")
    assert cfg.attn_impl_train == "chunked" and cfg.remat
    assert rows % cm.train_rows_unit(cfg, cell, mshape) == 0
    with cm.fake_mesh(mshape) as mesh:
        got = cm.reckon(cfg, cell, rows, mesh)
    assert got["total"] <= cm.BUDGET_BYTES
    assert got["total"] == got["params"] + got["opt"] + got["peak"]
    assert got["collectives"]["counts"]["all-reduce"] > 0


def test_yi_mesh_train_rows_fit_a_card():
    check_mesh_train_rows("yi-6b")
