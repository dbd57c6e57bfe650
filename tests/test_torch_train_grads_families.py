"""``Model.loss`` and its gradients (autograd) against
``jax.value_and_grad`` of the reference's loss on carried-across weights,
for the ssm, hybrid, audio and vlm configs (mamba2-780m,
recurrentgemma-9b, whisper-large-v3 with stub frames, qwen2-vl-72b with
M-RoPE) at float32 and bfloat16 compute;
``torch_lm_parity.check_loss_and_grads`` states the tolerances.
"""
import pytest

from torch_lm_parity import FAMILY_ARCHS, check_loss_and_grads
from torch_lm_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch, compute):
    check_loss_and_grads(arch, compute)
