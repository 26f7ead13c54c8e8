"""The port's bfloat16 train step against the JAX package's for
jamba-1.5-large-398b (Mamba, attention and MoE layers, bfloat16 moments)
at smoke size, with 1 and 2 microbatches: ``test_torch_bf16_train.py``'s
check, whose docstring argues each tolerance and jamba's wider ones (the
reference's own rounding).  A file of its own: one case takes about a
minute on one core, most of it the reference's ``jit``."""
import pytest

from test_torch_bf16_train import check_bf16_train_steps


@pytest.mark.parametrize("micro", [1, 2])
def test_bf16_train_step_matches_reference(micro):
    check_bf16_train_steps("jamba-1.5-large-398b", micro)
