"""Plain PyTorch versions of the block-statistics kernels.

They compute what ``src/repro/kernels/ref.py``'s ``block_stats_ref`` and
``block_stats_batched_ref`` compute, on any device: the CPU path of the
kernel wrappers, and what the tests and ``chip_smoke.py`` hold the CUDA
kernel against.  Counts and mass are summed as int64 and cast to float32
once, so mass is the exact sum rounded to float32; the reference sums mass
in float32, which is inexact past 2**24.
"""
from __future__ import annotations

import torch

__all__ = ["row_matches", "row_stats", "block_stats_ref",
           "block_stats_batched_ref"]


def row_matches(tokens: torch.Tensor, pattern) -> torch.Tensor:
    """Contiguous occurrences of ``pattern`` in each row of ``tokens``
    (..., L) -> (...) int64; a pattern longer than the row gives 0."""
    p = len(pattern)
    length = tokens.shape[-1]
    if length < p:
        return torch.zeros(tokens.shape[:-1], dtype=torch.int64,
                           device=tokens.device)
    hits = tokens[..., :length - p + 1] == int(pattern[0])
    for j in range(1, p):
        hits &= tokens[..., j:length - p + 1 + j] == int(pattern[j])
    return hits.sum(-1)


def row_stats(tokens: torch.Tensor, pattern) -> tuple:
    """Per-row ``(nonpad, matches, mass)`` of ``tokens`` (..., L), each an
    int64 tensor of shape (...)."""
    nonpad = (tokens != 0).sum(-1)
    mass = tokens.sum(-1, dtype=torch.int64)
    return nonpad, row_matches(tokens, pattern), mass


def block_stats_ref(tokens: torch.Tensor, pattern=(17, 23, 5)) -> torch.Tensor:
    """(N, L) int tokens -> (3,) float32 ``[nonpad, matches, mass]``."""
    return torch.stack([s.sum() for s in row_stats(tokens, pattern)]).to(
        torch.float32)


def block_stats_batched_ref(tokens: torch.Tensor, lengths=None,
                            pattern=(17, 23, 5)) -> torch.Tensor:
    """(nb, R, L) tokens [+ (nb,) valid-row counts] -> (nb, 3) float32.

    Rows at or past ``lengths[b]`` are left out: a length above R means all
    rows, 0 or a negative length none, ``None`` all rows of every block.
    """
    stats = torch.stack(row_stats(tokens, pattern), dim=-1)   # (nb, R, 3)
    if lengths is not None:
        n_blocks, rows, _ = tokens.shape
        lengths = torch.as_tensor(lengths, device=tokens.device).reshape(
            n_blocks).to(torch.int64)
        valid = torch.arange(rows, device=tokens.device)[None, :] \
            < lengths[:, None]
        stats = stats * valid[..., None]
    return stats.sum(dim=1).to(torch.float32)
