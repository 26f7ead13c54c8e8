"""Token blocks: the synthetic multi-source corpus (a NumPy copy of
``src/repro/data/synth.py``) and the block dataset.  ``packing`` is not
ported yet."""
from repro_torch.data.synth import SOURCES, SourceSpec, make_corpus_block
from repro_torch.data.blocks import BlockDataset, BlockStats

__all__ = ["SOURCES", "SourceSpec", "make_corpus_block", "BlockDataset",
           "BlockStats"]
