from repro_torch.parallel.sharding import (batch_specs, cache_specs,
                                           distribute_tree, mesh_shape_dict,
                                           param_specs, placements,
                                           validate_divisibility, zero1_specs)
from repro_torch.parallel.collectives import (hierarchical_grad_reduce,
                                              int8_all_reduce)

__all__ = ["batch_specs", "cache_specs", "param_specs", "zero1_specs",
           "validate_divisibility", "int8_all_reduce",
           "hierarchical_grad_reduce", "placements", "distribute_tree",
           "mesh_shape_dict"]
