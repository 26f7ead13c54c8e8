"""``cell_memory.MESH4_TRAIN`` reckoned at full size: musicgen-large's
``train_4k`` cell on (data 2, model 2), as ``chip_smoke.py --cards 4`` runs
it (see ``test_torch_mesh_train_rows_yi.py``); on 'data' of two the
moments are ZeRO-1 shards and the batch is split, so its rows divide into
the microbatches times two.
"""
from test_torch_mesh_train_rows_yi import check_mesh_train_rows


def test_musicgen_mesh_train_rows_fit_a_card():
    check_mesh_train_rows("musicgen-large")
