"""Block statistics — the paper's Algorithm 1 line 7 as one fused reduction.

Per data block: the non-pad token count, the grep-pattern match count and
the token mass (sum of ids), in one read of the block.  Two entries:

  * ``block_stats_cuda``          one block:  (N, L) -> (3,)
  * ``block_stats_batched_cuda``  nb blocks:  (nb, R, L) [+ (nb,) lengths]
                                  -> (nb, 3), one launch for every block

Both take tensors.  A CPU tensor goes to the plain version in
``repro_torch.kernels.ref``; a CUDA tensor goes to the CUDA kernel in
``csrc/block_stats.cu`` (built for ``sm_90a`` at first use), or the call
raises.  ``LAUNCHES`` counts each entry's kernel launches.  A call is one
device kernel: the output is the only allocation, and int32 or int64
``lengths`` on the card reach the kernel as they are (it clamps them).

Input rule: tokens are int32 of the stated rank, rows of under 2**30
tokens; a non-contiguous tensor is made contiguous (one copy) before the
launch.  Empty input returns zeros without a launch.  The pattern must hold
at least one token.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_stats_batched_ref, block_stats_ref

__all__ = ["LAUNCHES", "reset_launches", "block_stats_cuda",
           "block_stats_batched_cuda", "launch_shape", "occupancy"]

SOURCE = "block_stats.cu"

# kernel launches per entry point; chip_smoke.py zeroes them before the main
# path and reads them after it
LAUNCHES = {"block_stats": 0, "block_stats_batched": 0}

CLUSTER_SIZES = (1, 2, 4, 8, 16)
MIN_SPAN_BYTES = 16 << 10   # one ring stage: a CTA's share of a block is no less
MAX_LENGTH = 1 << 30        # the kernel carries columns in int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_shape(n_blocks: int, rows: int, length: int, slots: int,
                 max_cluster: int) -> tuple:
    """(C, clusters): the CTAs that share a block (a cluster) and how many
    clusters the persistent grid holds (each walks every clusters-th block).

    ``slots`` is the CTAs the card runs at once (SMs x CTAs an SM) and
    ``max_cluster`` the largest cluster it launches.  C doubles while the
    doubled grid still fits in ``slots`` and each CTA keeps at least a ring
    stage of the block; the grid then takes as many clusters as fit, at most
    one a block."""
    block_bytes = 4 * rows * length
    c = 1
    while (2 * c <= max_cluster and n_blocks * 2 * c <= slots
           and block_bytes >= 2 * c * MIN_SPAN_BYTES):
        c *= 2
    return c, max(1, min(n_blocks, slots // c))


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.block_stats_launch.argtypes is None:
        lib.block_stats_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2)
        lib.block_stats_launch.restype = ctypes.c_int
        lib.block_stats_occupancy.argtypes = [ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.block_stats_occupancy.restype = ctypes.c_int
        lib.block_stats_error_string.argtypes = [ctypes.c_int]
        lib.block_stats_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _launcher():
    """The C entry and the current-stream lookup, bound once."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        def raw(index):
            return torch.cuda.current_stream(index).cuda_stream
    return _library().block_stats_launch, raw


@functools.cache
def occupancy(index: int) -> dict:
    """What the runtime says of the kernel on CUDA device ``index``: threads
    and dynamic shared memory a CTA, CTAs an SM, SMs, the largest cluster it
    launches (16 where the card holds a cluster of 16, else 8) and how many
    clusters of that size it holds at once."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        err = lib.block_stats_occupancy(16, out)
        if err == 0 and out[3] == 0:
            err = lib.block_stats_occupancy(8, out)
            cluster = 8
        else:
            cluster = 16
    if err != 0:
        msg = lib.block_stats_error_string(err).decode()
        raise RuntimeError(f"block_stats occupancy query failed: {msg} "
                           f"({err})")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return {"threads": out[0], "smem_bytes": out[1], "ctas_per_sm": out[2],
            "sms": sms, "slots": sms * out[2], "max_cluster": cluster,
            "max_active_clusters": out[3]}


@functools.lru_cache(maxsize=256)
def _shape(index: int, n_blocks: int, rows: int, length: int) -> tuple:
    """``launch_shape`` on CUDA device ``index``."""
    facts = occupancy(index)
    return launch_shape(n_blocks, rows, length, facts["slots"],
                        facts["max_cluster"])


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
    if tokens.shape[-1] >= MAX_LENGTH:
        raise ValueError(f"rows of {tokens.shape[-1]} tokens: the limit is "
                         f"{MAX_LENGTH - 1}")


def _pattern(pattern) -> tuple:
    pattern = tuple(int(t) for t in pattern)
    if not pattern:
        raise ValueError("pattern must hold at least one token")
    return pattern


def _launch(name: str, tokens: torch.Tensor, lengths, pattern: tuple
            ) -> torch.Tensor:
    """Run the CUDA kernel on (nb, R, L) CUDA tokens; (nb, 3) float32.
    ``lengths`` is None or a contiguous (nb,) int32 or int64 CUDA tensor."""
    n_blocks, rows, length = tokens.shape
    launch, raw_stream = _launcher()
    tokens = tokens.contiguous()
    index = tokens.device.index
    cluster, clusters = _shape(index, n_blocks, rows, length)
    out = torch.empty((n_blocks, 3), dtype=torch.float32, device=tokens.device)
    args = (tokens.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            lengths is not None and lengths.dtype == torch.int64,
            _pattern_on(pattern, tokens.device).data_ptr(), len(pattern),
            n_blocks, rows, length, cluster, clusters, out.data_ptr())
    if index == torch.cuda.current_device():
        err = launch(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = launch(*args, raw_stream(index))
    if err != 0:
        msg = _library().block_stats_error_string(err).decode()
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
    rows of every block.  Integer lengths of any width count as they are
    (int64 ones past the int32 range clamp, they do not wrap).
    """
    _check_tokens(tokens, 3)
    pattern = _pattern(pattern)
    n_blocks = tokens.shape[0]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=tokens.device)
        if lengths.shape != (n_blocks,):
            raise ValueError(f"lengths must be ({n_blocks},), got "
                             f"{tuple(lengths.shape)}")
    if tokens.device.type == "cpu":
        return block_stats_batched_ref(tokens, lengths, pattern)
    if tokens.numel() == 0:
        return torch.zeros((n_blocks, 3), dtype=torch.float32,
                           device=tokens.device)
    if lengths is not None and lengths.dtype not in (torch.int32,
                                                     torch.int64):
        lengths = lengths.to(torch.int64)
    return _launch("block_stats_batched", tokens,
                   None if lengths is None else lengths.contiguous(), pattern)
