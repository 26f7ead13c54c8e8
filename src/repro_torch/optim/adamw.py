"""AdamW over parameter trees of tensors.

The port of ``src/repro/optim/adamw.py``.  Moments are stored in
``AdamWConfig.moment_dtype`` (float32 by default; bfloat16 for the 398B
config, where float32 moments would not fit).  The update is functional, as
the reference's pure step is: it returns new trees and never writes into the
ones it is given, so a caller may run a step and throw its result away (the
trainer's calibration steps do).

On DTensors each leaf's update runs in its moments' layout (ZeRO-1 when they
are laid out by ``parallel.zero1_specs``): the gradient and the parameter
are laid out as the moments are (a gradient still summed across ranks is
reduce-scattered onto the moments' shard in one collective,
``shards.relayout``), and the new parameter goes back to the parameter's
layout; the moments keep theirs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel.shards import match, relayout, replicate_like
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments beside each leaf, on its device; ``step`` an int32
    scalar on the device of the first leaf."""
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    first = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": replicate_like(step, first)}


def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None):
    """One AdamW step -> (new params, new state).  ``lr`` (a float or a
    float32 scalar tensor) overrides cfg.lr (schedules pass it per step).
    The bias corrections are float32, as the reference's; there is no decay
    on leaves of rank under 2 (norms, biases, scalars)."""
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p_in, g, m, v):
        p, gf = match(p_in, m), relayout(g, m).float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        if p.dim() >= 2:  # no decay on norms/biases/scalars
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return (relayout(p_new.to(p.dtype), p_in), m_new.to(m.dtype),
                v_new.to(v.dtype))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    # ``out`` has params' structure with a (p, m, v) triple at each leaf
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
