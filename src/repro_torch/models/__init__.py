"""The LM workload's models, ported from ``src/repro/models``: pure functions
over explicit parameter trees (dicts and tuples of tensors), with the JAX
package's layouts at every public function."""
