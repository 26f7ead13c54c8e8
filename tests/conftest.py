# Tests run on the single real CPU device (the 512-device XLA_FLAGS override is
# set ONLY inside launch/dryrun.py, never globally).
import os
import sys

# keep test determinism and avoid accidental flag leakage from the environment
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's hand-written "
        "kernels); skips where torch sees none")
