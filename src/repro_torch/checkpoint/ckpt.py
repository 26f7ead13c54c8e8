"""Fault-tolerant checkpointing: atomic, async, in the reference's format.

The port of ``src/repro/checkpoint/ckpt.py``.  Format: ``arrays.npz`` holds
one full host array per leaf, keyed by its path (dict keys and sequence
indices joined with ``§``, as ``models.convert.flatten`` keys them), and
``meta.json`` holds the step, the keys, ``extra`` and ``"complete": true``.
A checkpoint written by either package loads in the other.

bfloat16 leaves, without JAX: NumPy has no bfloat16 type, and the
reference's ``ml_dtypes`` arrays land in the ``.npz`` as 2-byte void
(``|V2``) arrays of bfloat16 bit patterns.  The port reads such an array as
those bits (``view(int16)`` into a bfloat16 tensor), and writes its own
bfloat16 leaves as float32, which holds every bfloat16 value exactly and
which the reference's loader casts back (it cannot cast its own ``|V2``
arrays).  Every other dtype is written as it is.

Write protocol: temp dir -> fsync -> atomic rename; a crash mid-write can
never corrupt the latest valid checkpoint.  ``CheckpointManager`` keeps the
newest K, saves on a thread from a host snapshot taken at ``save()``, and
restores the newest VALID one (torn writes are skipped).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import flatten, tree_map_with_path

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy for a CPU tensor too) that NumPy can
    save, bfloat16 widened to float32, exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _from_host(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """``arr`` (an array ``np.load`` made) as a tensor of ``like``'s dtype
    on ``device``."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if like.dtype != torch.bfloat16:   # bfloat16 bits from ml_dtypes
            raise ValueError(f"2-byte void leaf for a {like.dtype} leaf")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device, like.dtype)


def save_checkpoint(path: str, tree: Any, *, step: int,
                    extra: dict | None = None):
    """Atomically write ``tree`` (tensors or host arrays) to ``path`` (a
    directory)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    flat = {k: _to_host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in flatten(tree).items()}
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        meta = {
            "step": int(step),
            "keys": sorted(flat.keys()),
            # the reference writes JAX's treedef string here; nothing reads it
            "treedef": f"repro_torch tree of {len(flat)} leaves",
            "extra": extra or {},
            "complete": True,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_checkpoint(path: str, like: Any, *, device="cuda") -> tuple:
    """Restore into the structure, shapes and dtypes of ``like`` (a tree of
    tensors), every leaf on ``device``.

    Returns (tree, step).  Raises FileNotFoundError / ValueError / KeyError
    on missing, torn or mismatched checkpoints.
    """
    dev = resolve_device(device)
    meta_p = os.path.join(path, "meta.json")
    if not os.path.exists(meta_p):
        raise FileNotFoundError(path)
    with open(meta_p) as f:
        meta = json.load(f)
    if not meta.get("complete"):
        raise ValueError(f"torn checkpoint: {path}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}

    def load(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        if tuple(flat[key].shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{flat[key].shape} vs {tuple(leaf.shape)}")
        return _from_host(flat[key], leaf, dev)

    return tree_map_with_path(load, like), int(meta["step"])


class CheckpointManager:
    """keep-K manager with async save and newest-valid restore."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree: Any, step: int, extra: dict | None = None):
        self.wait()  # one in-flight save at a time
        # snapshot off the device NOW: the caller may free or replace the
        # tensors while the write runs
        host_tree = tree_map_with_path(lambda _, t: _to_host(t), tree)

        def work():
            try:
                save_checkpoint(self._ckpt_path(step), host_tree, step=step,
                                extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._ckpt_path(s), ignore_errors=True)

    def restore_latest(self, like: Any, *, device="cuda"):
        """Newest VALID checkpoint as (tree, step), or None if none
        loads."""
        self.wait()
        for step in reversed(self.steps()):
            try:
                return load_checkpoint(self._ckpt_path(step), like,
                                       device=device)
            except (ValueError, KeyError, FileNotFoundError, OSError):
                continue  # torn/corrupt: try older
        return None
