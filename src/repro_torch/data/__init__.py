"""Token blocks: the synthetic multi-source corpus and token packing (NumPy
copies of ``src/repro/data/synth.py`` and ``packing.py``) and the block
dataset."""
from repro_torch.data.synth import SOURCES, SourceSpec, make_corpus_block
from repro_torch.data.blocks import BlockDataset, BlockStats
from repro_torch.data.packing import PackedBatch, pack_tokens

__all__ = ["SOURCES", "SourceSpec", "make_corpus_block", "BlockDataset",
           "BlockStats", "pack_tokens", "PackedBatch"]
