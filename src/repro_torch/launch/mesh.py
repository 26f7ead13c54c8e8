"""Production meshes, as ``DeviceMesh``es.  Functions (not module constants),
so importing this module touches no process group.

The port of ``src/repro/launch/mesh.py``.  A mesh of N devices needs a
default process group of N ranks already started: the ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``) for shape work
in one process, gloo or NCCL for a real run.  ``mesh_shape_dict`` lives in
``parallel.sharding`` (the models read it) and is re-exported here.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.parallel.sharding import mesh_shape_dict

__all__ = ["make_production_mesh", "make_mesh", "mesh_shape_dict"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh(shape: dict, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` (axis name -> size, in mesh order), e.g.
    ``{"data": 2, "model": 2}``."""
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))

