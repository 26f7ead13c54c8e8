"""Public entry points of the port's kernels.

Each takes array-likes or tensors and ``device=`` (default ``"cuda"``): the
input moves to that device once, and the kernel wrapper then runs the CUDA
kernel on a CUDA tensor or the plain version on a CPU tensor.  Without a
CUDA device, a call that does not pass ``device="cpu"`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import to_device
from repro_torch.kernels.block_stats import (block_stats_batched_cuda,
                                             block_stats_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda

__all__ = ["flash_attention", "ssd_scan", "block_stats",
           "block_stats_batched"]


def flash_attention(q, k, v, *, causal: bool = True, swa_window=None,
                    block_q: int = 128, block_k: int = 128, device="cuda"
                    ) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.

    Refuses what the reference refuses: S not a multiple of
    ``min(block, S)`` here, Hq not a multiple of Hkv in the wrapper.  The
    block sizes shape only that check: the CUDA kernel picks its own tiles.
    """
    q, k, v = (to_device(t, device) for t in (q, k, v))
    s = q.shape[-2]
    for name, block in (("block_q", block_q), ("block_k", block_k)):
        if block < 1 or s % min(block, s):
            raise ValueError(f"S={s} is not a multiple of {name}="
                             f"{min(block, s)}")
    return flash_attention_cuda(q, k, v, causal=causal, swa_window=swa_window)


def ssd_scan(x, dt, a_log, b_mat, c_mat, *, chunk: int = 128,
             device="cuda") -> torch.Tensor:
    """x (BH, S, P), dt (BH, S), a_log (BH,), b/c (BH, S, N) -> y (BH, S, P)
    in x's dtype; the SSD chunk scan with A = -exp(a_log), the state carried
    in float32, no D-skip term, no final state (as the reference returns).

    Refuses what the reference refuses: S not a multiple of
    ``min(chunk, S)``.  ``chunk`` shapes only that check and the CPU path:
    the CUDA kernel picks its own chunk.  Each row of BH is its own head and
    group (B = 1, H = G = BH), passed to the kernel as strided views.
    """
    x, dt, a_log, b_mat, c_mat = (to_device(t, device)
                                  for t in (x, dt, a_log, b_mat, c_mat))
    for name, t, rank in (("x", x, 3), ("dt", dt, 2), ("a_log", a_log, 1),
                          ("b_mat", b_mat, 3), ("c_mat", c_mat, 3)):
        if t.dim() != rank:
            raise ValueError(f"{name} must have rank {rank}, got shape "
                             f"{tuple(t.shape)}")
    s = x.shape[1]
    if chunk < 1 or (s and s % min(chunk, s)):
        raise ValueError(f"S={s} is not a multiple of chunk={min(chunk, s)}")
    x, dt, b_mat, c_mat = (t.transpose(0, 1)[None]   # (1, S, BH, ...) views
                           for t in (x, dt.float(), b_mat, c_mat))
    y = ssd_scan_cuda(x, dt, a_log.float(), b_mat, c_mat, chunk=chunk)
    return y[0].transpose(0, 1)


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
