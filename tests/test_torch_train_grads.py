"""``Model.loss`` and its gradients (autograd) against
``jax.value_and_grad`` of the reference's loss on carried-across weights,
for the attention configs (dense and MoE) at float32 and bfloat16 compute;
``torch_lm_parity.check_loss_and_grads`` states the tolerances, and
``test_torch_train_grads_families.py`` runs the other four configs.
"""
import pytest

from repro_torch.configs import list_archs
from torch_lm_parity import (ATTENTION_ARCHS, FAMILY_ARCHS,
                             check_loss_and_grads)
from torch_lm_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_loss_and_grads_match_jax(arch, compute):
    check_loss_and_grads(arch, compute)


def test_the_two_parity_files_cover_every_config():
    assert sorted(ATTENTION_ARCHS + FAMILY_ARCHS) == sorted(list_archs())
