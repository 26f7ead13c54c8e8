"""Mamba-2 SSD chunk scan in the model's layout.

``ssd_scan_cuda(x, dt, a_log, b_mat, c_mat, chunk=, final_state=)`` takes
x (B, S, H, P), dt (B, S, H) float32 (post-softplus), a_log (H,) float32 and
B/C (B, S, G, N) with H a multiple of G, and returns y (B, S, H, P) in x's
type, with the final state (B, H, P, N) float32 when ``final_state``.  A CPU
tensor goes to the plain chunked version in ``repro_torch.kernels.ref``
(chunked by ``chunk`` as the reference model chunks); a CUDA tensor goes to
the CUDA kernels in ``csrc/ssd_scan.cu`` (built for ``sm_90a`` at first use),
or the call raises.  ``LAUNCHES`` counts the calls that launched them.

One call launches two device kernels (``DEVICE_KERNELS``): C B^T once per
(batch, group, 64-row chunk) into a float32 scratch of ``scratch_shape``
that the wrapper allocates, then the scan, one CTA per (batch, head, slice
of ``p_slice(P)`` head-dim columns), with the next chunk staged while the
current one is computed.  ``ref.ssd_split_ref`` is the same split in plain
PyTorch.

Input rule: x, B and C of one dtype (float32 or bfloat16), dt and a_log
float32, P and N in ``SIZES``.  The kernels read every input through its
strides, so the model's views (x a reshape of the conv output, B and C
slices of ``bc_conv``, one group for many heads) are neither copied nor
repeated per head.  x, B and C are staged in 16-byte pieces, so one whose
base is not 16-byte aligned, whose last dimension is not contiguous or
whose other strides are not positive multiples of 16 bytes is copied once
(``flash_attention.tma_ready`` and ``prepare``, the rule the flash kernels
follow).  y has x's memory layout (``torch.empty_like``) where that allows
16-byte stores.  The kernels pick
their own chunk length (64 rows); ``chunk`` shapes only the CPU path.

Gradients.  Under grad mode, with an input that requires grad, the call
goes through ``SsdScan``, a ``torch.autograd.Function``: its forward is the
route above; its backward sends a CPU tensor to
``ref.ssd_chunked_bwd_ref`` (autograd of the plain chunked version) and a
CUDA tensor to ``ssd_scan_bwd_cuda``, the hand-written backward in
``csrc/ssd_scan_bwd.cu`` (three device kernels a call, ``BWD_DEVICE_KERNELS``;
float32 or bfloat16 inputs, every sum in float32, each gradient in its
input's dtype; no atomics: two calls give the same bits), counted in
``LAUNCHES["ssd_scan_bwd"]``.  It recomputes the chunk-entry states (at
its own 32-row chunks, ``bwd_n_chunks``), so the forward writes nothing
more for it, and sums dB and dC over each cluster of ``bwd_cluster(H, G)``
heads in shared memory.  Without grad the call is the serving path as it
was.

Meta tensors (shapes only, as the dry run lays a model out) are a third
route of their own: the forward gives y in x's type and the float32 final
state, and ``SsdScan``'s backward the five gradients in the card's
backward's dtypes (each input's), all on ``meta``; nothing is launched and
``LAUNCHES`` does not move.  ``META_FLOPS`` adds up the operations of
those calls by the count the kernels' bounds use (``forward_flops``,
``backward_flops``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
# the 16-byte copy rule the flash kernels follow holds for cp.async here too
from repro_torch.kernels.flash_attention import prepare, tma_ready
from repro_torch.kernels.ref import (SSD_BWD_CHUNK, SSD_CHUNK, SSD_P_SLICE,
                                     ssd_chunked_bwd_ref, ssd_chunked_ref)

__all__ = ["LAUNCHES", "SIZES", "DEVICE_KERNELS", "BWD_DEVICE_KERNELS",
           "reset_launches", "p_slice", "n_chunks", "scratch_shape", "ctas",
           "fmas", "smem_bytes", "occupancy", "bwd_n_chunks",
           "bwd_cluster", "bwd_smem_bytes", "bwd_scratch_bytes", "bwd_fmas",
           "bwd_occupancy", "SsdScan", "ssd_scan_cuda",
           "ssd_scan_bwd_cuda", "META_FLOPS", "reset_meta_flops",
           "forward_flops", "flops_per_token_head", "backward_flops"]

SOURCE = "ssd_scan.cu"
BWD_SOURCE = "ssd_scan_bwd.cu"
SIZES = (8, 16, 32, 64, 128)
DEVICE_KERNELS = 2       # C B^T, then the scan
BWD_DEVICE_KERNELS = 3   # the states, the chunks' gradients, the group sums
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may have on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches; chip_smoke.py zeroes them before a path and reads them
# after
LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}


# operations of the calls on meta tensors (no launch), by the bounds' count;
# the dry run reads them
META_FLOPS = {"ssd_scan": 0.0, "ssd_scan_bwd": 0.0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reset_meta_flops() -> None:
    for name in META_FLOPS:
        META_FLOPS[name] = 0.0


def forward_flops(bsz: int, s: int, h: int, p: int, n: int) -> int:
    """Operations of the forward's bound: 4 P N a (token, head), the
    state's update and read-out that every exact algorithm does."""
    return 4 * p * n * bsz * s * h


def flops_per_token_head(s: int, p: int, n: int) -> tuple:
    """(float32 operations a (token, head), chunk length L) of the least
    exact backward we can argue, for a cotangent of y alone.

    Every (token, head) takes five products the size of the state, 2 P N
    operations each (P N FMAs): the state entering its chunk recomputed
    (the sum of u_j B_j^T), the state's cotangent (the sum of dy_i C_i^T),
    and the inter-chunk terms of dC (h_{c-1}^T dy_i), du (dh_c B_j) and dB
    (dh_c^T u_j): 10 P N.  A chunk of L rows adds, once for each (chunk,
    head), the decay of the state and of its cotangent (P N each) and d a's
    state term <dh_c, h_{c-1}> (2 P N): 4 P N / L a token; and, over its
    L (L + 1) / 2 causal pairs (i >= j), C_i.B_j (2 N), dy_i.u_j (2 P) and
    the pair's shares of du (2 P), dC (2 N) and dB (2 N): (L + 1)(2 P + 3 N)
    a token.  L is the one in 1..S that makes the sum least (8 at P = 64,
    N = 128: 11.0625 P N).  Terms of order P or N alone (the exponential
    scalings of B_j and C_i, d seg, the group sums) are left out, which only
    lowers the count."""
    return min((10 * p * n + 4 * p * n / L + (L + 1) * (2 * p + 3 * n), L)
               for L in range(1, s + 1))



def backward_flops(bsz: int, s: int, h: int, p: int, n: int) -> float:
    """Operations of the backward's bound: ``flops_per_token_head`` for
    each of the B S H (token, head)s (11.0625 P N at P = 64, N = 128)."""
    return flops_per_token_head(s, p, n)[0] * bsz * s * h


def p_slice(p: int) -> int:
    """Head-dim columns one scan CTA owns (a divisor of P)."""
    return min(p, SSD_P_SLICE)


def n_chunks(s: int) -> int:
    """64-row chunks of a sequence of S rows, the last one maybe short."""
    return -(-s // SSD_CHUNK)


def scratch_shape(bsz: int, s: int, g: int) -> tuple:
    """Shape of the float32 C B^T scratch of one call."""
    return (bsz, g, n_chunks(s), SSD_CHUNK, SSD_CHUNK)


def ctas(bsz: int, s: int, h: int, g: int, p: int) -> dict:
    """CTAs of the two kernels of one call."""
    return {"cb": bsz * g * n_chunks(s), "scan": bsz * h * (p // p_slice(p))}


def fmas(bsz: int, s: int, h: int, g: int, p: int, n: int) -> int:
    """Float32 FMAs the two kernels of one call do: per (chunk, head) 64 P N
    for C h^T, 64 P N for the state update and 2048 P for the causal M x (a
    thread's 8 rows run to the diagonal in 4-row steps); per (chunk, group)
    64 * 64 * N for C B^T."""
    nc, rows = n_chunks(s), SSD_CHUNK
    return (nc * bsz * h * (2 * rows * p * n + 2048 * p)
            + nc * bsz * g * rows * rows * n)


def smem_bytes(p: int, n: int) -> dict:
    """Dynamic shared memory (bytes) a CTA of each kernel asks for, as
    ``csrc/ssd_scan.cu`` computes it: the scan kernel's two stages of x
    slice, B, C, C B^T and dt, the state and each update warp's w; the
    C B^T kernel's B and C (rows padded to N + 4)."""
    ps, rows = p_slice(p), SSD_CHUNK
    stage = rows * ps + 2 * rows * n + rows * rows + rows
    return {"scan": 4 * (2 * stage + n * ps + 4 * rows),
            "cb": 4 * 2 * rows * (n + 4)}


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if lib.ssd_scan_launch.argtypes is None:
        lib.ssd_scan_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_occupancy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_occupancy.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def occupancy(dtype: torch.dtype, p: int, n: int) -> dict:
    """How the CUDA runtime sees the two kernels for inputs of ``dtype``,
    head dim ``p`` and state dim ``n`` on the current card: threads and
    dynamic shared memory (bytes) a CTA and CTAs an SM at once, of the scan
    kernel (``threads``, ``smem_bytes``, ``ctas_per_sm``) and of the C B^T
    kernel (the same keys with ``cb_`` in front).  (Registers and spills
    are in the build's ptxas log.)"""
    lib = _library()
    out = (ctypes.c_int * 6)()
    err = lib.ssd_scan_occupancy(_DTYPES[dtype], int(p), int(n), out)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan occupancy query failed: {msg} ({err})")
    keys = ("threads", "smem_bytes", "ctas_per_sm")
    return dict(zip(keys + tuple("cb_" + k for k in keys), out))


def _check(x, dt, a_log, b_mat, c_mat) -> None:
    named = (("x", x), ("dt", dt), ("a_log", a_log), ("b_mat", b_mat),
             ("c_mat", c_mat))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{name} on unsupported device {t.device}")
    for name, t, rank in (("x", x, 4), ("dt", dt, 3), ("a_log", a_log, 1),
                          ("b_mat", b_mat, 4), ("c_mat", c_mat, 4)):
        if t.dim() != rank:
            raise ValueError(f"{name} must have rank {rank}, got shape "
                             f"{tuple(t.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.dtype == b_mat.dtype == c_mat.dtype):
        raise TypeError(f"x, b_mat, c_mat differ in dtype: {x.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"dt and a_log must be float32, got {dt.dtype} and "
                        f"{a_log.dtype}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("x, dt, a_log, b_mat, c_mat lie on different "
                         "devices")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a_log.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / a_log {tuple(a_log.shape)}"
                         f" do not match x {tuple(x.shape)}")
    if tuple(b_mat.shape) != (bsz, s, g, n) or c_mat.shape != b_mat.shape:
        raise ValueError(f"b_mat {tuple(b_mat.shape)} / c_mat "
                         f"{tuple(c_mat.shape)} do not match x "
                         f"{tuple(x.shape)} in batch and length, or differ")
    if g == 0 or h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if p not in SIZES or n not in SIZES:
        raise ValueError(f"head dim P={p} and state dim N={n} must be in "
                         f"{SIZES}")


def _launch(lib, x, dt, a_log, b_mat, c_mat, y, state, cb) -> int:
    """Call the C entry on tensors that satisfy ``_check`` and
    ``tma_ready``; returns its error code."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    strides = [t.stride()[:3] for t in (x, dt, b_mat, c_mat, y)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None, cb.data_ptr(),
        _DTYPES[x.dtype], bsz, s, h, g, p, n, cb.shape[2],
        *[v for st in strides for v in st], stream)


def _scan(x, dt, a_log, b_mat, c_mat, chunk: int,
          final_state: bool = True) -> tuple:
    """(y, final state) of inputs that satisfy ``_check``: the plain
    chunked version on a CPU tensor, the CUDA kernels on a CUDA tensor
    and shapes alone on a meta tensor (both of which give the state only
    when ``final_state``; else it is None)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, a_log, b_mat, c_mat, chunk=chunk)
    if x.device.type == "meta":
        return _meta_scan(x, b_mat, final_state)
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    x, b_mat, c_mat = prepare(x), prepare(b_mat), prepare(c_mat)
    y = torch.empty_like(x)
    if not tma_ready(y):
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    run = bool(bsz and s and h)
    state = None
    if final_state:   # the kernel writes every entry; S = 0 leaves zeros
        state = (torch.empty if run else torch.zeros)(
            (bsz, h, p, n), dtype=torch.float32, device=x.device)
    if run:
        lib = _library()
        cb = torch.empty(scratch_shape(bsz, s, g), dtype=torch.float32,
                         device=x.device)
        with torch.cuda.device(x.device):
            err = _launch(lib, x, dt, a_log.contiguous(), b_mat, c_mat, y,
                          state, cb)
        if err != 0:
            msg = lib.ssd_scan_error_string(err).decode()
            raise RuntimeError(f"ssd_scan CUDA launch failed: {msg} ({err})")
        LAUNCHES["ssd_scan"] += 1
    return y, state


def _meta_scan(x, b_mat, final_state: bool) -> tuple:
    """(y, final state or None) of meta inputs: shapes and types only."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    META_FLOPS["ssd_scan"] += forward_flops(bsz, s, h, p, n)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device="meta") if final_state else None
    return torch.empty(x.shape, dtype=x.dtype, device="meta"), state


def _meta_grads(x, dt, a_log, b_mat, c_mat) -> tuple:
    """The backward's five gradients of meta inputs, each of its input's
    shape and dtype, as the backward kernels write them."""
    bsz, s, h, p = x.shape
    META_FLOPS["ssd_scan_bwd"] += backward_flops(bsz, s, h, p,
                                                 b_mat.shape[3])
    return tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for t in (x, dt, a_log, b_mat, c_mat))


class SsdScan(torch.autograd.Function):
    """(y, final state) of the SSD scan, with its backward: on a CPU tensor
    autograd of the plain chunked version, on a CUDA tensor the backward
    kernels, on a meta tensor the gradients' shapes and types.  A
    gradient that is None (y or the state unused) is zero."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, chunk: int):
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _scan(x, dt, a_log, b_mat, c_mat, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_log, b_mat, c_mat = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = ssd_chunked_bwd_ref(x, dt, a_log, b_mat, c_mat, dy,
                                        dstate, chunk=ctx.chunk)
        elif x.device.type == "meta":
            grads = _meta_grads(x, dt, a_log, b_mat, c_mat)
        else:
            grads = ssd_scan_bwd_cuda(x, dt, a_log, b_mat, c_mat, dy, dstate)
        return (*grads, None)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                  chunk: int = 256, final_state: bool = False):
    """x (B,S,H,P), dt (B,S,H), a_log (H,), b/c (B,S,G,N) -> y (B,S,H,P) in
    x's dtype, or (y, state (B,H,P,N) float32) when ``final_state``.  Under
    grad mode with an input that requires grad it runs through ``SsdScan``,
    whose backward is ``ssd_scan_bwd_cuda`` on the card."""
    _check(x, dt, a_log, b_mat, c_mat)
    ins = (x, dt, a_log, b_mat, c_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        y, state = SsdScan.apply(*ins, chunk)
    else:
        y, state = _scan(*ins, chunk, final_state)
    return (y, state) if final_state else y


# ------------------------------------------------------------- backward --

def bwd_n_chunks(s: int) -> int:
    """32-row chunks of the backward kernels over S rows, the last one
    maybe short."""
    return -(-s // SSD_BWD_CHUNK)


def bwd_cluster(h: int, g: int) -> int:
    """CTAs (heads of one group) a cluster of the backward's chunk kernel
    holds: the largest of 8, 4, 2 and 1 that divides H / G.  Their dB and
    dC are summed in distributed shared memory."""
    return next(c for c in (8, 4, 2, 1) if (h // g) % c == 0)


BWD_RING = (8, 3)   # rows of h_{c-1} a ring stage holds, stages


def bwd_smem_bytes(p: int, n: int) -> dict:
    """Dynamic shared memory (bytes) a CTA of the backward's states and
    chunk kernels asks for, as ``csrc/ssd_scan_bwd.cu`` computes it: the
    states kernel's two stages of an x (or dy) slice, B (or C) and dt, and
    the rows' weights; the chunk kernel's x, dy, B and C (rows padded by 4
    floats), dh_c, the ring of h_{c-1}, K and W (rows of L + 4), and its
    partial row sums."""
    rows, ps = SSD_BWD_CHUNK, p_slice(p)
    ring_rows, stages = BWD_RING
    states = 2 * (rows * (ps + n) + rows) + rows + 4
    chunk = (2 * rows * (p + 4) + 2 * rows * (n + 4) + p * n
             + stages * ring_rows * n + 2 * rows * (rows + 4) + rows * 32
             + rows * max(p // 4, rows // 2) + 7 * rows + 8)
    return {"states": 4 * states, "chunk": 4 * chunk}


def bwd_scratch_bytes(bsz: int, s: int, h: int, g: int, p: int, n: int
                      ) -> int:
    """Bytes of float32 scratch one backward call allocates: the states
    entering and the cotangents leaving each 32-row chunk (B, H, nc, P, N),
    dB and dC summed over each cluster's heads (B, S, H / cs, N), and each
    chunk's share of da_log."""
    nc = bwd_n_chunks(s)
    return 4 * (2 * bsz * h * nc * p * n
                + 2 * bsz * s * (h // bwd_cluster(h, g)) * n + bsz * nc * h)


def bwd_fmas(bsz: int, s: int, h: int, p: int, n: int) -> int:
    """Float32 FMAs the backward kernels do, loop by loop as they run: per
    (32-row chunk, head) C B^T and dy x^T whole (L L (N + P)), du's state
    term (L P N) and its causal part over i >= j in 4-row steps, dC's and
    dB's state terms (2 L P N) and causal parts, <dh, h> (P N), and 2 L P N
    in the states kernel."""
    rows = SSD_BWD_CHUNK
    du_pairs = sum(2 * p * (rows - (j0 & ~3)) for j0 in range(0, rows, 2))
    dcb_pairs = sum(4 * n * ((i0 + 4) + (rows - i0))
                    for i0 in range(0, rows, 4))
    per = (rows * rows * (n + p) + rows * p * n + du_pairs + 2 * rows * p * n
           + dcb_pairs + p * n + 2 * rows * p * n)
    return bwd_n_chunks(s) * bsz * h * per


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    if lib.ssd_scan_bwd_launch.argtypes is None:
        lib.ssd_scan_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
            + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.ssd_scan_bwd_launch.restype = ctypes.c_int
        lib.ssd_scan_bwd_occupancy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_bwd_occupancy.restype = ctypes.c_int
        lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_occupancy(p: int, n: int, dtype: torch.dtype = torch.float32
                  ) -> dict:
    """Dynamic shared memory (bytes) a CTA of the states kernel and of the
    chunk kernel asks for, and CTAs an SM of each, for inputs of ``dtype``,
    as the CUDA runtime sees them on the current card."""
    lib = _bwd_library()
    out = (ctypes.c_int * 4)()
    err = lib.ssd_scan_bwd_occupancy(_DTYPES[dtype], int(p), int(n), out)
    if err != 0:
        msg = lib.ssd_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"ssd_scan_bwd occupancy query failed: {msg} "
                           f"({err})")
    return dict(zip(("states_smem_bytes", "chunk_smem_bytes",
                     "chunk_ctas_per_sm", "states_ctas_per_sm"), out))


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b_mat: torch.Tensor, c_mat: torch.Tensor, dy,
                      dstate=None) -> tuple:
    """The backward kernels on CUDA tensors: the gradients (dx, ddt, da_log,
    dB, dC) of ``ssd_scan_cuda``'s (y, final state) for the cotangents
    ``dy`` (B,S,H,P) in x's dtype and ``dstate`` (B,H,P,N) float32 (None
    for either means zero).  x, B, C (and dy) float32 or bfloat16, dt and
    a_log float32; every sum in float32, each gradient in its input's
    dtype."""
    _check(x, dt, a_log, b_mat, c_mat)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd_cuda takes CUDA tensors, got "
                         f"{x.device}; the CPU route is "
                         "ref.ssd_chunked_bwd_ref")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    dev = x.device
    run = bool(bsz and s and h) and (dy is not None or dstate is not None)
    # the kernels write every entry of a launched call's gradients
    grads = tuple((torch.empty if run else torch.zeros)(
        t.shape, dtype=t.dtype, device=dev)
        for t in (x, dt, a_log, b_mat, c_mat))
    if not run:
        return grads
    if dy is None:
        dy = torch.zeros((1, 1, 1, 1), dtype=x.dtype,
                         device=dev).expand(bsz, s, h, p)
    for name, t, shape, dtype in (("dy", dy, (bsz, s, h, p), x.dtype),
                                  ("dstate", dstate, (bsz, h, p, n),
                                   torch.float32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or t.device != dev):
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    x, dy, b_mat, c_mat = (prepare(t) for t in (x, dy, b_mat, c_mat))
    if dstate is not None:   # read 16 bytes at a time, contiguous
        dstate = dstate.contiguous()
        if dstate.data_ptr() % 16:
            dstate = dstate.clone()
    nc, cs = bwd_n_chunks(s), bwd_cluster(h, g)
    states = torch.empty((2, bsz, h, nc, p, n), dtype=torch.float32,
                         device=dev)
    sums = torch.empty((2, bsz, s, h // cs, n), dtype=torch.float32,
                       device=dev)
    part = torch.empty((bsz, nc, h), dtype=torch.float32, device=dev)
    dx, ddt, da_log, db, dc = grads
    lib = _bwd_library()
    strides = [t.stride()[:3] for t in (x, dt, b_mat, c_mat, dy)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), a_log.contiguous().data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), dy.data_ptr(),
            dstate.data_ptr() if dstate is not None else None,
            dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(), db.data_ptr(),
            dc.data_ptr(), states[0].data_ptr(), states[1].data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), part.data_ptr(),
            _DTYPES[x.dtype], bsz, s, h, g, p, n, nc, cs,
            *[v for st in strides for v in st], stream)
    if err != 0:
        msg = lib.ssd_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"ssd_scan_bwd CUDA launch failed: {msg} ({err})")
    LAUNCHES["ssd_scan_bwd"] += 1
    return grads
