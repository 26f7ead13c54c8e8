"""Mixture-of-Experts configuration, copied from ``src/repro/models/moe.py``.

Only ``MoEConfig`` is here for now, because the configs need it.  The MoE FFN
itself comes with a later slice of the port (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses

__all__ = ["MoEConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # number of always-on shared experts
    d_ff_shared: int = 0        # total shared hidden size (n_shared * d_ff_expert)
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"
    router_aux_weight: float = 0.01
    # dispatch groups: ranking/scatter happen independently per group so nothing
    # (cumsum, scatter) ever crosses the data-sharded token dim.  Set to the DP
    # shard count in distributed runs; 1 on a single device.
    dispatch_groups: int = 1
    group_axis: str | None = None   # mesh axis to shard groups over (e.g. 'data')
    # true expert parallelism: shard the expert dim of the weights over this
    # axis (requires n_experts % axis_size == 0).  The dispatch buffer is then
    # resharded group-axis <-> expert-axis around the expert einsums — the
    # classic EP all-to-all — instead of moving expert WEIGHTS.
    expert_axis: str | None = None
