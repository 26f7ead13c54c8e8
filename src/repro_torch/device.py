"""The port's device rule: run on the card unless the caller asks for the CPU;
and the card's own numbers, for rooflines and kernel bounds."""
from __future__ import annotations

import torch

from repro_torch.core.estimator import ChipSpec

__all__ = ["resolve_device", "to_device", "H100", "HBM_BYTES_PER_S",
           "F32_FLOPS", "BF16_FLOPS"]

# H100 SXM, NVIDIA's data sheet, at its 700 W power limit: device memory,
# dense float32 without tensor cores, dense bf16 on tensor cores, NVLink each
# way.  A card set to a lower limit runs slower under load.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
H100 = ChipSpec(peak_flops=F32_FLOPS, hbm_bw=HBM_BYTES_PER_S, ici_bw=450e9,
                hbm_bytes=80e9)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no CUDA device, rather than running on the CPU in its place.  ``"meta"``
    builds shapes only (``launch/specs.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def to_device(x, device="cuda") -> torch.Tensor:
    """``x`` (array-like or tensor) as a tensor on ``device``; no copy when it
    already lies there."""
    return torch.as_tensor(x, device=resolve_device(device))
