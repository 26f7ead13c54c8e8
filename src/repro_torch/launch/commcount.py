"""Collective accounting of eager torch: the bytes each device's collectives
leave on it, by kind.

It stands in for ``src/repro/launch/hloparse.py``.  That module reads the
per-device HLO text XLA compiles and multiplies each ``while`` body's
collectives by the loop's trip count, because a compiled loop body appears
once in the text however often it runs.  Torch has no HLO: the port runs
eagerly, every trip of a Python loop issues its collectives again, and so
the collectives are counted here as they are issued, by a
``TorchDispatchMode`` (``CollectiveCounter``) around the call.

What is counted, per device (the local ops DTensor runs on each rank's
shards, and the collectives a caller issues on local tensors):

* ``_c10d_functional`` all_reduce, all_gather_into_tensor,
  reduce_scatter_tensor and all_to_all_single (and their in-place and
  coalesced forms), which DTensor's redistributions issue;
* DTensor's ``_dtensor.shard_dim_alltoall`` (a Shard(i) -> Shard(j)
  move), as an all-to-all.  On a mesh whose device type is ``"cpu"``
  DTensor replaces it with an all-gather and a chunk (gloo has no
  all-to-all), so lay out on a ``"cuda"``-typed mesh to count what NCCL
  is asked for;
* the ``c10d`` ops that ``torch.distributed``'s calls (``all_reduce``,
  ``all_gather``, ``reduce_scatter_tensor``, ``all_to_all_single``, ...)
  dispatch, as ``parallel/collectives.py`` makes them;
* ``c10d.recv_`` as a collective-permute (its received buffer; a send
  leaves no buffer on its device).

The bytes of one collective follow ``hloparse``'s convention
(``_buffer_bytes`` of the type left of the op): the bytes of its result
buffer on one device.  DTensor also runs every op once at its global shape
under a ``FakeTensorMode`` to propagate the sharding; those calls are not
the device's work and are not counted (nor is anything else run while a
``FakeTensorMode`` is on the mode stack).

``result()`` has ``parse_collectives``' shape: ``looped`` and ``raw``, each
``{kind: bytes, ..., "total": bytes}``, and ``counts`` ``{kind: ops}``.
Since every trip of a loop is executed and counted, ``looped`` is what was
issued; ``raw`` holds the same numbers (there is no static, once-a-body
count of an eager run to report apart from it).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

__all__ = ["COLLECTIVE_KINDS", "CollectiveCounter", "result_bytes"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

# op packet name -> (kind, where its result buffer is: "out" for the op's
# return value, "arg0" for its first argument, the tensors a c10d op
# writes)
_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                          "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "out"),
    "c10d.allreduce_": ("all-reduce", "arg0"),
    "c10d.allreduce_coalesced_": ("all-reduce", "arg0"),
    "c10d.allgather_": ("all-gather", "arg0"),
    "c10d._allgather_base_": ("all-gather", "arg0"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "c10d.allgather_coalesced_": ("all-gather", "arg0"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg0"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "c10d.alltoall_": ("all-to-all", "arg0"),
    "c10d.alltoall_base_": ("all-to-all", "arg0"),
    "c10d.recv_": ("collective-permute", "arg0"),
}


def result_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a tensor, or nested lists and
    tuples of them): ``numel * element_size``, each tensor once."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def in_fake_mode() -> bool:
    """True while a ``FakeTensorMode`` is on the dispatch mode stack (DTensor
    propagating a sharding at global shapes)."""
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def is_local(args, kwargs) -> bool:
    """True for an op a device runs: no fake tensor among its arguments and
    no ``FakeTensorMode`` on the stack."""
    if in_fake_mode():
        return False
    return not any(isinstance(t, FakeTensor)
                   for t in tree_leaves((args, kwargs)))


class CollectiveCounter(TorchDispatchMode):
    """Counts, while it is on, every collective issued on local tensors: its
    kind and its result buffer's bytes (``result()``).

    ``local_op(func, args, kwargs, out)`` is called for every local op (a
    device's work on plain tensors; DTensor ops are left to DTensor, which
    runs its local ops through this mode again); a subclass may extend it
    to count more than collectives."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.counts = {k: 0 for k in COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if is_local(args, kwargs):
            self.local_op(func, args, kwargs, out)
        return out

    def local_op(self, func, args, kwargs, out) -> None:
        hit = _OPS.get(str(func.overloadpacket))
        if hit is None:
            return
        kind, where = hit
        self.bytes[kind] += result_bytes(out if where == "out" else args[0])
        self.counts[kind] += 1

    def result(self) -> dict:
        looped = {**self.bytes, "total": sum(self.bytes.values())}
        return {"looped": looped, "raw": dict(looped),
                "counts": dict(self.counts)}
