"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the public entry points (``ops``).  Sources live in ``csrc/`` and are built
by ``_build`` at first use, never when a module is imported."""
