"""The port's bfloat16 train step against the JAX package's for the MoE and
Mamba archs of ``tests/test_torch_train.py:LOSS_ARCHS``, at smoke size,
with 1 and 2 microbatches: ``test_torch_bf16_train.py``'s check, whose
docstring argues each tolerance.  Jamba has a file of its own
(``test_torch_bf16_train_jamba.py``), so that each of the three files runs
in about two minutes on one core."""
import pytest

from test_torch_bf16_train import check_bf16_train_steps

MOE_SSM_ARCHS = ("mixtral-8x7b", "qwen2-moe-a2.7b", "mamba2-1.3b")


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_bf16_train_step_matches_reference(arch, micro):
    check_bf16_train_steps(arch, micro)
