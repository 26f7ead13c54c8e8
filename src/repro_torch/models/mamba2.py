"""Mamba-2 (SSD) configuration, copied from ``src/repro/models/mamba2.py``.

Only ``SSMConfig`` is here for now, because the configs need it.  The Mamba-2
block itself (chunked SSD, decode, prefill) and its ``ssd_scan`` kernel come
with a later slice of the port (ROADMAP Queue 1 item 9, Queue 2 item 4).
"""
from __future__ import annotations

import dataclasses

__all__ = ["SSMConfig"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def d_bc(self) -> int:
        return 2 * self.n_groups * self.d_state
