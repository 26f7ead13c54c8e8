"""Flash attention forward (GQA, causal or not, optional sliding window).

``flash_attention_cuda(q, k, v, causal=, swa_window=)`` takes q (B, Hq, S, D)
and k, v (B, Hkv, S, D), float32 or bfloat16, and returns (B, Hq, S, D) in
q's type.  A CPU tensor goes to the plain version in
``repro_torch.kernels.ref``; a CUDA tensor goes to one of two CUDA kernels
(built for ``sm_90a`` at first use), or the call raises; a meta tensor gives
the output's shape and type alone (``launch/cell_memory.py`` reckons a
model's memory so).  ``LAUNCHES`` counts the launches.  Both kernels
replace ``flash_attention_kernel`` / ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:28``, ``:79``); the route is chosen
by the input type (``route``):

* bfloat16, ``csrc/flash_attention_bf16.cu``: bound by the bytes at the
  serving shape (989 TFLOP/s of tensor-core math outruns 3.35 TB/s).  A
  persistent grid of warp-specialised CTAs, one an SM: two consumer
  warpgroups (128 q rows) take turns running ``wgmma`` on 128-key tiles that
  one TMA loader thread brings in through a 2-stage mbarrier ring, with the
  softmax in registers and P fed to ``wgmma`` from registers.  The CTAs
  take work items from a counter in device memory, one a stream, that the
  last CTA of each launch zeroes for the next.
* float32, ``csrc/flash_attention_f32.cu``: bound by operations at the
  67 TFLOP/s float32 rate (the kernel never uses TF32).  256 threads own a
  128-row q tile; each thread an 8 x 4 score tile and an 8-row slice of the
  output in registers; K and V come through a 2-stage ``cp.async`` ring that
  overlaps the next tile's copy with the current tile's FMAs, with one
  block-wide barrier a tile.

Input rule: rank 4, one dtype (float32 or bfloat16) for all three, Hq a
multiple of Hkv, k and v of one shape, D in ``HEAD_DIMS``.  Both kernels read
q, k and v through their strides, so the transposed views the model hands in
are not copied.  Both copy in 16-byte pieces (TMA, ``cp.async``), so a
tensor whose base is not 16-byte aligned, whose last dimension is not
contiguous, or whose other strides are not positive multiples of 16 bytes is
copied once into a contiguous tensor (``tma_ready``, ``prepare``).  The
output has q's memory layout (``torch.empty_like``), so the model's transpose
back is free.  The kernels tile by themselves; they take no block sizes.
A negative ``swa_window`` is refused: the reference masks every key for one,
which gives a result that depends on its tile sizes.  The kernels have no
backward, so a call that would need one (grad mode on and an input that
requires grad) is refused on both devices (``refuse_grad``) rather than
returning an output without a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["LAUNCHES", "HEAD_DIMS", "SOURCES", "reset_launches", "route",
           "tma_ready", "prepare", "refuse_grad", "occupancy",
           "flash_attention_cuda"]

# one CUDA source (and library) per input type
SOURCES = {torch.float32: "flash_attention_f32.cu",
           torch.bfloat16: "flash_attention_bf16.cu"}
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches; chip_smoke.py zeroes it before the serving path and reads
# it after
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def route(dtype: torch.dtype) -> str:
    """The CUDA source whose kernel takes inputs of ``dtype``."""
    try:
        return SOURCES[dtype]
    except KeyError:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}") from None


def _library(dtype: torch.dtype) -> ctypes.CDLL:
    lib = _build.load(route(dtype))
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_occupancy.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_occupancy.restype = ctypes.c_int
    return lib


def occupancy(dtype: torch.dtype, d: int) -> dict:
    """How the CUDA runtime sees the kernel of this route and head dim on the
    current card: threads and dynamic shared memory (bytes) a CTA, CTAs an
    SM at once.  (Registers and spills a thread are in the build's ptxas
    log, ``_build.build(route(dtype))``.)"""
    lib = _library(dtype)
    out = (ctypes.c_int * 3)()
    err = lib.flash_attention_occupancy(int(d), out)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention occupancy query failed: {msg} "
                           f"({err})")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"), out))


def _check(q, k, v, swa_window=None) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must have rank 4 (B, H, S, D), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in SOURCES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.device.type not in ("cpu", "cuda", "meta"):
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
    if swa_window is not None and swa_window < 0:
        raise ValueError(f"swa_window={swa_window} is negative; give None or "
                         "0 for no window, or a positive window")


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a backward of ``kernel``: its CUDA
    output is written through ctypes and carries no ``grad_fn``.  Raised on
    both devices, so the CPU's plain version cannot train what the card
    cannot."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel, so its output would carry no "
            "gradient; call it under torch.no_grad() or on inputs that do not "
            "require grad (training through it is ROADMAP Queue 1 item 15, "
            "its flash part)")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the kernels can copy ``t`` (B, H, S, D) in 16-byte pieces as
    it lies: base 16-byte aligned, D contiguous, the B, H and S strides
    positive multiples of 16 bytes (what TMA's tensor maps and ``cp.async``
    need)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(st > 0 and st * t.element_size() % 16 == 0
               for st in t.stride()[:3])


def prepare(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if ``tma_ready``, else one contiguous, aligned copy."""
    if tma_ready(t):
        return t
    c = t.contiguous()
    return c if tma_ready(c) else c.clone()


def _launch(lib, q, k, v, out, causal: bool, window: int) -> int:
    """Call the C entry on tensors that satisfy ``_check`` and ``tma_ready``;
    returns its error code."""
    b, hq, s, d = q.shape
    strides = [t.stride()[:3] for t in (q, k, v, out)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        k.shape[1], s, d, int(bool(causal)), int(window),
        *[x for st in strides for x in st], stream)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, swa_window=None
                         ) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.
    ``swa_window`` None or 0 means no sliding window; a negative one is
    refused, and so is a call under grad on an input that requires grad
    (``refuse_grad``)."""
    _check(q, k, v, swa_window)
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   swa_window=swa_window)
    if q.device.type == "meta":     # shapes only: nothing is launched
        return torch.empty_like(q)
    if q.shape[0] == 0 or q.shape[1] == 0 or q.shape[2] == 0:
        return torch.empty_like(q)
    q, k, v = prepare(q), prepare(k), prepare(v)
    out = torch.empty_like(q)
    lib = _library(q.dtype)
    with torch.cuda.device(q.device):
        err = _launch(lib, q, k, v, out, causal, int(swa_window or 0))
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention CUDA launch failed: {msg} "
                           f"({err})")
    LAUNCHES["flash_attention"] += 1
    return out
