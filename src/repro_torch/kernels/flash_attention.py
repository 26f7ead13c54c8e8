"""Flash attention forward (GQA, causal or not, optional sliding window).

``flash_attention_cuda(q, k, v, causal=, swa_window=)`` takes q (B, Hq, S, D)
and k, v (B, Hkv, S, D), float32 or bfloat16, and returns (B, Hq, S, D) in
q's type.  A CPU tensor goes to the plain version in
``repro_torch.kernels.ref``; a CUDA tensor goes to the CUDA kernel in
``csrc/flash_attention.cu`` (built for ``sm_90a`` at first use), or the call
raises.  ``LAUNCHES`` counts the kernel's launches.

Input rule: rank 4, one dtype (float32 or bfloat16) for all three, Hq a
multiple of Hkv, k and v of one shape, D in ``HEAD_DIMS``.  The kernel reads
q, k and v through their strides, so the transposed views the model hands in
are not copied; a tensor whose last dimension is not contiguous is copied
once.  The output has q's memory layout (``torch.empty_like``), so the model's
transpose back is free.  The CUDA kernel tiles by itself (64 queries x 64
keys); it has no block-size arguments.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["LAUNCHES", "HEAD_DIMS", "reset_launches", "flash_attention_cuda"]

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches; chip_smoke.py zeroes it before the serving path and reads
# it after
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must have rank 4 (B, H, S, D), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} on unsupported device {t.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    b, hq, s, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; one of {HEAD_DIMS}")


def _launch(lib, q, k, v, out, causal: bool, window: int) -> int:
    """Call the C entry on tensors that satisfy ``_check``; returns its
    error code."""
    b, hq, s, d = q.shape
    strides = [t.stride()[:3] for t in (q, k, v, out)]
    stream = torch.cuda.current_stream(q.device).cuda_stream \
        if q.is_cuda else None
    return lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, k.shape[1], s, d, int(bool(causal)),
        int(window), *[x for st in strides for x in st], stream)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, swa_window=None
                         ) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.
    ``swa_window`` falsy means no sliding window."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   swa_window=swa_window)
    if q.shape[0] == 0 or q.shape[1] == 0 or q.shape[2] == 0:
        return torch.empty_like(q)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = _launch(lib, q, k, v, out, causal, int(swa_window or 0))
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention CUDA launch failed: {msg} "
                           f"({err})")
    LAUNCHES["flash_attention"] += 1
    return out
