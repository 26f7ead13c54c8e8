"""The serving engine of the LM workload, ported from ``src/repro/serve``."""
from repro_torch.serve.engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
