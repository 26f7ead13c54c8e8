"""Public entry points of the port's kernels.

Each takes array-likes or tensors and ``device=`` (default ``"cuda"``): the
input moves to that device once, and the kernel wrapper then runs the CUDA
kernel on a CUDA tensor or the plain version on a CPU tensor.  Without a
CUDA device, a call that does not pass ``device="cpu"`` raises.
``flash_attention`` and ``ssd_scan`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.device import to_device
from repro_torch.kernels.block_stats import (block_stats_batched_cuda,
                                             block_stats_cuda)

__all__ = ["block_stats", "block_stats_batched"]


def block_stats(tokens, pattern: tuple = (17, 23, 5), *, device="cuda"
                ) -> torch.Tensor:
    """One block: (N, L) int32 -> (3,) float32 ``[nonpad, matches, mass]``."""
    return block_stats_cuda(to_device(tokens, device), pattern)


def block_stats_batched(tokens, lengths=None, pattern: tuple = (17, 23, 5),
                        *, device="cuda") -> torch.Tensor:
    """Whole-dataset stats: (n_blocks, R, L) [+ (n_blocks,) lengths] ->
    (n_blocks, 3) float32, in one kernel launch."""
    return block_stats_batched_cuda(to_device(tokens, device), lengths,
                                    pattern)
