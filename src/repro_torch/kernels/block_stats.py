"""Block statistics — the paper's Algorithm 1 line 7 as one fused reduction.

Per data block: the non-pad token count, the grep-pattern match count and
the token mass (sum of ids), in one read of the block.  Two entries:

  * ``block_stats_cuda``          one block:  (N, L) -> (3,)
  * ``block_stats_batched_cuda``  nb blocks:  (nb, R, L) [+ (nb,) lengths]
                                  -> (nb, 3), one launch for every block

Both take tensors.  A CPU tensor goes to the plain version in
``repro_torch.kernels.ref``; a CUDA tensor goes to the CUDA kernel in
``csrc/block_stats.cu`` (built for ``sm_90a`` at first use), or the call
raises.  ``LAUNCHES`` counts each entry's kernel launches.

Input rule: tokens are int32 of the stated rank; a non-contiguous tensor is
made contiguous (one copy) before the launch.  Empty input returns zeros
without a launch.  The pattern must hold at least one token.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_stats_batched_ref, block_stats_ref

__all__ = ["LAUNCHES", "reset_launches", "block_stats_cuda",
           "block_stats_batched_cuda", "tile_rows"]

SOURCE = "block_stats.cu"

# kernel launches per entry point; chip_smoke.py zeroes them before the main
# path and reads them after it
LAUNCHES = {"block_stats": 0, "block_stats_batched": 0}

_TILE_TOKENS = 4096   # tokens a CTA reduces when there are enough CTAs
_MIN_CTAS = 1024      # ~8 a streaming multiprocessor on an H100 (132 SMs)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tile_rows(n_blocks: int, rows: int, length: int) -> int:
    """Rows a CTA reduces: ~``_TILE_TOKENS`` tokens, halved while the grid
    would have fewer than ``_MIN_CTAS`` CTAs, so one block spreads over many."""
    t = max(1, min(rows, _TILE_TOKENS // max(length, 1)))
    while t > 1 and n_blocks * -(-rows // t) < _MIN_CTAS:
        t //= 2
    return t


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.block_stats_launch.argtypes is None:
        lib.block_stats_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 3)
        lib.block_stats_launch.restype = ctypes.c_int
        lib.block_stats_error_string.argtypes = [ctypes.c_int]
        lib.block_stats_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _pattern_on(pattern: tuple, device: torch.device) -> torch.Tensor:
    """The pattern as a device int32 array, copied to the card once."""
    return torch.tensor(pattern, dtype=torch.int32, device=device)


def _check_tokens(tokens, ndim: int) -> None:
    if not isinstance(tokens, torch.Tensor):
        raise TypeError(f"tokens must be a torch.Tensor, got {type(tokens)}")
    if tokens.dim() != ndim:
        raise ValueError(f"tokens must have rank {ndim}, got shape "
                         f"{tuple(tokens.shape)}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32, got {tokens.dtype}")
    if tokens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tokens on unsupported device {tokens.device}")


def _pattern(pattern) -> tuple:
    pattern = tuple(int(t) for t in pattern)
    if not pattern:
        raise ValueError("pattern must hold at least one token")
    return pattern


def _launch(name: str, tokens: torch.Tensor, lengths, pattern: tuple
            ) -> torch.Tensor:
    """Run the CUDA kernel on (nb, R, L) CUDA tokens; (nb, 3) float32."""
    n_blocks, rows, length = tokens.shape
    lib = _library()
    tokens = tokens.contiguous()
    dev = tokens.device
    pat = _pattern_on(pattern, dev)
    acc = torch.empty((n_blocks, 3), dtype=torch.int64, device=dev)
    out = torch.empty((n_blocks, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.block_stats_launch(
            tokens.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            pat.data_ptr(), len(pattern), n_blocks, rows, length,
            tile_rows(n_blocks, rows, length), acc.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        msg = lib.block_stats_error_string(err).decode()
        raise RuntimeError(f"{name} CUDA launch failed: {msg} ({err})")
    LAUNCHES[name] += 1
    return out


def block_stats_cuda(tokens: torch.Tensor, pattern=(17, 23, 5)
                     ) -> torch.Tensor:
    """tokens (N, L) int32 -> (3,) float32 ``[nonpad, matches, mass]``."""
    _check_tokens(tokens, 2)
    pattern = _pattern(pattern)
    if tokens.device.type == "cpu":
        return block_stats_ref(tokens, pattern)
    if tokens.numel() == 0:
        return torch.zeros(3, dtype=torch.float32, device=tokens.device)
    return _launch("block_stats", tokens[None], None, pattern)[0]


def block_stats_batched_cuda(tokens: torch.Tensor, lengths=None,
                             pattern=(17, 23, 5)) -> torch.Tensor:
    """tokens (nb, R, L) int32 [+ (nb,) valid-row counts] -> (nb, 3) float32.

    Rows at or past ``lengths[b]`` are left out even when they hold the
    pattern; a length above R means all rows, 0 or less none, ``None`` all
    rows of every block.
    """
    _check_tokens(tokens, 3)
    pattern = _pattern(pattern)
    n_blocks, rows, _ = tokens.shape
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=tokens.device)
        if lengths.shape != (n_blocks,):
            raise ValueError(f"lengths must be ({n_blocks},), got "
                             f"{tuple(lengths.shape)}")
        lengths = lengths.to(torch.int64).clamp(0, rows).to(torch.int32)
    if tokens.device.type == "cpu":
        return block_stats_batched_ref(tokens, lengths, pattern)
    if tokens.numel() == 0:
        return torch.zeros((n_blocks, 3), dtype=torch.float32,
                           device=tokens.device)
    return _launch("block_stats_batched", tokens, lengths, pattern)
