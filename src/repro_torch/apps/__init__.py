"""The paper's five evaluation workloads, in PyTorch.

Port of ``src/repro/apps``.  Each app exposes:
  * ``run(block, *, device="cuda")`` — computation over one data block,
  * ``flops(block_stats) -> float``    — analytic cost (drives the estimator),
  * ``cost_features(stats) -> dict``   — features for the linear CostModel.

These are plain tensor operations: the reference computes them with jnp, not
with a Pallas kernel, so none of them has a hand-written kernel.
"""
from repro_torch.apps.wordcount import WordCount
from repro_torch.apps.grep import Grep
from repro_torch.apps.inverted_index import InvertedIndex
from repro_torch.apps.aggregate import Average, Sum
from repro_torch.apps.base import App, measure_block_seconds

ALL_APPS = {
    "wordcount": WordCount,
    "grep": Grep,
    "inverted_index": InvertedIndex,
    "avg": Average,
    "sum": Sum,
}

__all__ = ["App", "WordCount", "Grep", "InvertedIndex", "Average", "Sum",
           "ALL_APPS", "measure_block_seconds"]
