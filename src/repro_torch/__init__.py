"""DV-DVFS in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The port of ``src/repro`` (JAX on a TPU), which stays beside it as the
reference.  Module paths and public names follow the reference
(``repro_torch.kernels.ops.block_stats_batched`` <->
``repro.kernels.ops.block_stats_batched``).  This package imports torch and
numpy only: the NumPy host layers it needs (``core``, ``data.synth``) are
copies, never imports of ``repro``.

Device rule: every entry point takes ``device=`` and defaults to ``"cuda"``.
Without a CUDA device a call that does not pass ``device="cpu"`` raises; a
kernel wrapper sends a CPU tensor to its plain version and a CUDA tensor to
its CUDA kernel, and never falls back from one to the other.
"""
