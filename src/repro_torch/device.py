"""The port's device rule: run on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no CUDA device, rather than running on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def to_device(x, device="cuda") -> torch.Tensor:
    """``x`` (array-like or tensor) as a tensor on ``device``; no copy when it
    already lies there."""
    return torch.as_tensor(x, device=resolve_device(device))
