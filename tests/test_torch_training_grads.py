"""The port's ``lm_loss`` and its gradients against the JAX reference's, on
the CPU: reduced ``granite_3_2b`` and ``gpt_36b`` in f32, on the
reference's einsum path and its Pallas path in interpret mode, with and
without packed segments, under every remat policy.  Loss 1e-5 relative,
gradients 5e-4 (``test_torch_training._check_loss_and_grads``).  A file of
its own so that ``--dist loadfile`` runs it beside the rest of the
training slice's tests."""

import pytest

from test_torch_training import ARCHS, _check_loss_and_grads


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path", ["default", "pallas"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("remat", ["none", "full", "dots", "stage"])
def test_lm_loss_and_grads_match_reference(arch, path, packed, remat):
    _check_loss_and_grads(arch, path, packed, remat)
