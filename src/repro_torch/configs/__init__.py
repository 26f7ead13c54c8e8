"""Copied from ``src/repro/configs/__init__.py``, imports pointed at ``repro_torch``."""
from repro_torch.configs.base import ARCH_IDS, ArchConfig, LayerSpec, get_arch
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable_cells, cell_applicable
from repro_torch.configs.smoke import smoke_config

__all__ = ["ARCH_IDS", "ArchConfig", "LayerSpec", "get_arch", "SHAPES",
           "ShapeCell", "applicable_cells", "cell_applicable", "smoke_config"]
