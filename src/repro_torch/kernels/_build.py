"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is compiled
for Hopper (``sm_90a``) into ``build/kernels/<hash>/lib<name>.so`` at the
root of the checkout; the hash covers the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew.
Nothing here runs when the module is imported.  If ``nvcc`` is missing or
the build fails, the caller gets the error: there is no other way to run a
kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["Built", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One built library: its path, the nvcc wall time in seconds (0 when it
    was already built) and what nvcc printed (register and shared-memory use
    from ``-Xptxas -v``; kept beside the library as ``lib<name>.log``)."""

    source: str
    path: Path
    seconds: float
    log: str


_BUILT: dict = {}   # source name -> Built
_LIBS: dict = {}    # source name -> ctypes.CDLL


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(f"nvcc not found on PATH or at {NVCC_DEFAULT}: the "
                       "CUDA kernels cannot be built")


def _target(source: str) -> Path:
    src = CSRC / source
    text = src.read_bytes() + b"".join(h.read_bytes()
                                       for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_ROOT / digest / f"lib{src.stem}.so"


def build(*sources: str) -> list:
    """Build ``sources`` (file names under ``csrc/``), one nvcc each, all
    started together; returns a ``Built`` for each, in order."""
    pending = {}
    nvcc = None
    for source in sources:
        if source in _BUILT:
            continue
        out = _target(source)
        if out.exists():
            log = out.with_suffix(".log")
            _BUILT[source] = Built(source, out, 0.0,
                                   log.read_text() if log.exists() else "")
            continue
        nvcc = nvcc or _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[source] = (proc, tmp, out, time.perf_counter())
    failures = []
    for source, (proc, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
        _BUILT[source] = Built(source, out, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [_BUILT[s] for s in sources]


def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, building it if need be."""
    lib = _LIBS.get(source)
    if lib is None:
        (built,) = build(source)
        lib = _LIBS[source] = ctypes.CDLL(str(built.path))
    return lib
